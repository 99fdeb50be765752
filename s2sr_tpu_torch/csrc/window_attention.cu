// Swin block and window attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of s2sr_tpu/ops/pallas/window_attention.py:
//   - swin_block_fused (body _block_kernel): the whole Swin block,
//       y   = x + proj(attn(LN1(x)))
//       out = y + fc2(gelu(fc1(LN2(y))))
//   - window_attention_fused (body _attn_kernel): LN1 -> attention -> proj,
//     written without the residual (the caller adds it and runs the MLP).
// Both run one device function; the flag `mlp` picks the whole block.
//
// The configuration is SwinIR-M's (both registry SwinIR models): C = 180,
// 6 heads of 30 (padded to 32 with zero weight columns, as the TPU tables
// are), window 8 (64 tokens), MLP hidden 360. Attention runs over plain
// 8x8 windows; the TPU kernel's window pairs only filled its 128-lane MXU.
// A shifted block works in the space rolled by -shift: the kernel folds
// the roll into its addressing, reading and writing each token at its
// own place in the unrolled map, and adds one of 4 shift masks (0/-100)
// chosen by 2*(last window row) + (last window column) of the rolled grid.
//
// Numerics (shared with the plain version, ops/window_attention.py):
// LayerNorm statistics, every product sum, scores + bias + mask and the
// softmax in float32; values rounded to the storage type (float32 or
// bfloat16) where the TPU kernel stores them: LN outputs, q/k/v, softmax
// weights, head outputs, fc1 output, GELU output, the output. y, the
// residual stream between attention and MLP, stays float32. GELU: exact
// erff for float32 storage, the tanh form for bfloat16.
//
// What bounds it: operations. A block costs 564,480 FLOP per token
// (qkv 194,400, proj 64,800, fc1 and fc2 129,600 each, QK^T and PV 23,040
// each) against 720 bytes per token in bf16 (x read once, out written
// once): ~780 FLOP per byte, above the H100's ~295 FLOP/byte balance.
// The design keeps everything between x and out in shared memory, so the
// kernel's time is its arithmetic, and streams the ~0.5 MB of weights of
// a block from L2, which all windows share. This first version does the
// arithmetic in float32 FMA on the CUDA cores (67 TFLOP/s peak), not on
// the tensor cores (989 TFLOP/s bf16): mma/wgmma are the next step.
//
// Structure: one thread block of 256 threads per window. Shared memory
// (float32, 225,152 bytes, one block per SM):
//   X   64 x 180   x, then y in place
//   LN  64 x 180   LN1 output, then LN2 output
//   R   attention phase: QKV of two heads (64 x 193), their scores
//       (2 x 64 x 65), the 6 heads' outputs O (64 x 196);
//       MLP phase: the GELU'd hidden H (64 x 360)
// Matrix products C[64 x 192] += A[64 x K] (shared) * W[K x 192] (global,
// read through L1): thread (ry, cx) owns rows ry + 16i (i < 4) and columns
// 12cx..12cx+11, 48 accumulators; per k it loads 4 values of A and 12 of W
// for 48 FMAs. Row strides are odd or 4 mod 32 so that the two rows a warp
// reads, and the per-row reads of the score and PV loops, hit distinct
// banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 180;          // embedding
constexpr int HEADS = 6;
constexpr int DP = 32;          // head_dim 30, padded
constexpr int WIN = 8;
constexpr int N = WIN * WIN;    // tokens per window
constexpr int HID = 360;        // MLP hidden
constexpr int CP = 192;         // C padded (columns of wo, w2)
constexpr int HP = 384;         // hidden padded (columns of w1)
constexpr int QKV_N = HEADS * 3 * DP;   // 576 columns of wqkv
constexpr int THREADS = 256;
constexpr float EPS = 1e-5f;

// shared-memory layout, in floats
constexpr int LDX = C;                  // X and LN row stride
constexpr int LDQ = 193;                // QKV of a head pair: 2 x [q|k|v]
constexpr int LDS = 65;                 // scores row stride
constexpr int S_HEAD = N * LDS + 16;    // scores head stride
constexpr int LDO = 196;                // head outputs
constexpr int LDH = HID;                // hidden
constexpr int OFF_X = 0;
constexpr int OFF_LN = OFF_X + N * LDX;
constexpr int OFF_R = OFF_LN + N * LDX;
constexpr int OFF_QKV = OFF_R;
constexpr int OFF_S = OFF_QKV + N * LDQ;
constexpr int OFF_O = OFF_S + 2 * S_HEAD;
constexpr int R_ATTN = N * LDQ + 2 * S_HEAD + N * LDO;
constexpr int R_MLP = N * LDH;
constexpr int SMEM_FLOATS = OFF_R + (R_ATTN > R_MLP ? R_ATTN : R_MLP);
constexpr size_t SMEM_BYTES = (size_t)SMEM_FLOATS * sizeof(float);
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may opt into");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round a float32 to the storage type and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// 12 consecutive weights, 16-byte (float) / 8-byte (bf16) aligned
__device__ __forceinline__ void load12(const float* __restrict__ p,
                                       float* w) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 t = __ldg(q + i);
    w[4 * i + 0] = t.x;
    w[4 * i + 1] = t.y;
    w[4 * i + 2] = t.z;
    w[4 * i + 3] = t.w;
  }
}
__device__ __forceinline__ void load12(const __nv_bfloat16* __restrict__ p,
                                       float* w) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint2 t = __ldg(q + i);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    w[4 * i + 0] = a.x;
    w[4 * i + 1] = a.y;
    w[4 * i + 2] = b.x;
    w[4 * i + 3] = b.y;
  }
}

// acc[i][j] = sum_k A[ry + 16i][k] * W[k][n0 + 12cx + j], then
// epi(row, col, acc) for each of the thread's 48 outputs.
template <typename T, int K, typename Epi>
__device__ __forceinline__ void gemm64x192(const float* __restrict__ A,
                                           int lda,
                                           const T* __restrict__ W, int ldw,
                                           int n0, Epi epi) {
  const int ry = threadIdx.x >> 4;
  const int cx = threadIdx.x & 15;
  float acc[4][12];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j] = 0.f;
  const float* ap = A + ry * lda;
  const T* wp = W + n0 + cx * 12;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], w[12];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ap[i * 16 * lda + k];
    load12(wp + (size_t)k * ldw, w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) epi(ry + 16 * i, n0 + cx * 12 + j, acc[i][j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dst[r][c] = rnd((src[r][c] - mean) * rstd * g[c] + b[c]); a warp per row
template <typename T>
__device__ __forceinline__ void layer_norm(const float* __restrict__ src,
                                           float* __restrict__ dst,
                                           const float* __restrict__ g,
                                           const float* __restrict__ b) {
  constexpr int PER = (C + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < N; r += THREADS / 32) {
    float v[PER];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = lane + 32 * k;
      v[k] = c < C ? src[r * LDX + c] : 0.f;
      s += v[k];
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = lane + 32 * k;
      const float d = c < C ? v[k] - mean : 0.f;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / C + EPS);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = lane + 32 * k;
      if (c < C)
        dst[r * LDX + c] = rnd<T>((v[k] - mean) * rstd * __ldg(g + c)
                                  + __ldg(b + c));
    }
  }
}

template <typename T> __device__ __forceinline__ float gelu(float h);
template <> __device__ __forceinline__ float gelu<float>(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}
template <> __device__ __forceinline__ float gelu<__nv_bfloat16>(float h) {
  const float u = 0.7978845608028654f * (h + 0.044715f * h * h * h);
  return 0.5f * h * (1.f + tanhf(u));
}

template <typename T, bool MLP>
__global__ void __launch_bounds__(THREADS, 1)
swin_kernel(const T* __restrict__ x, T* __restrict__ out,
            const float* __restrict__ g1, const float* __restrict__ b1,
            const T* __restrict__ wqkv, const float* __restrict__ bqkv,
            const T* __restrict__ wo, const float* __restrict__ bo,
            const float* __restrict__ pos_bias,
            const float* __restrict__ masks,
            const float* __restrict__ g2, const float* __restrict__ b2,
            const T* __restrict__ w1, const float* __restrict__ bf1,
            const T* __restrict__ w2, const float* __restrict__ bf2,
            int H, int W, int shift) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem + OFF_X;
  float* sln = smem + OFF_LN;
  float* sqkv = smem + OFF_QKV;
  float* ss = smem + OFF_S;
  float* so = smem + OFF_O;
  float* sh = smem + OFF_R;

  const int nwh = H / WIN;
  const int nww = W / WIN;
  const int win = blockIdx.x;
  const int b = win / (nwh * nww);
  const int wy = (win / nww) % nwh;
  const int wx = win % nww;
  const float* mask =
      shift > 0 ? masks + (2 * (wy == nwh - 1) + (wx == nww - 1)) * N * N
                : nullptr;
  // element offset of token r (row-major in the rolled window) in x/out
  auto pix = [&](int r) -> size_t {
    const int gy = (wy * WIN + (r >> 3) + shift) % H;
    const int gx = (wx * WIN + (r & 7) + shift) % W;
    return (((size_t)b * H + gy) * W + gx) * C;
  };

  for (int i = threadIdx.x; i < N * C; i += THREADS) {
    const int r = i / C;
    const int c = i - r * C;
    sx[r * LDX + c] = to_f(x[pix(r) + c]);
  }
  __syncthreads();
  layer_norm<T>(sx, sln, g1, b1);
  __syncthreads();

  for (int hp = 0; hp < HEADS / 2; ++hp) {
    // q, k, v of heads 2hp and 2hp+1: columns hp*192 .. +192 of wqkv
    gemm64x192<T, C>(sln, LDX, wqkv, QKV_N, hp * 192,
                     [&](int r, int n, float v) {
                       sqkv[r * LDQ + n - hp * 192] =
                           rnd<T>(v + __ldg(bqkv + n));
                     });
    __syncthreads();
    {
      // scores: thread -> row i, columns jq + 4m
      const int i = threadIdx.x >> 2;
      const int jq = threadIdx.x & 3;
#pragma unroll 1
      for (int hh = 0; hh < 2; ++hh) {
        const float* q = sqkv + i * LDQ + hh * 96;
        float qr[DP];
#pragma unroll
        for (int d = 0; d < DP; ++d) qr[d] = q[d];
#pragma unroll 4
        for (int m = 0; m < N / 4; ++m) {
          const int j = jq + 4 * m;
          const float* k = sqkv + j * LDQ + hh * 96 + DP;
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DP; ++d) s = fmaf(qr[d], k[d], s);
          ss[hh * S_HEAD + i * LDS + j] = s;
        }
      }
    }
    __syncthreads();
    {
      // + bias + mask, softmax: a warp per row, two columns per lane
      const int warp = threadIdx.x >> 5;
      const int lane = threadIdx.x & 31;
      for (int row = warp; row < 2 * N; row += THREADS / 32) {
        const int hh = row / N;
        const int i = row - hh * N;
        const float* bias = pos_bias + ((size_t)(2 * hp + hh) * N + i) * N;
        float* srow = ss + hh * S_HEAD + i * LDS;
        float s0 = srow[lane] + __ldg(bias + lane);
        float s1 = srow[lane + 32] + __ldg(bias + lane + 32);
        if (mask) {
          s0 += __ldg(mask + i * N + lane);
          s1 += __ldg(mask + i * N + lane + 32);
        }
        const float m = warp_max(fmaxf(s0, s1));
        const float e0 = expf(s0 - m);
        const float e1 = expf(s1 - m);
        const float sum = warp_sum(e0 + e1);
        srow[lane] = rnd<T>(e0 / sum);
        srow[lane + 32] = rnd<T>(e1 / sum);
      }
    }
    __syncthreads();
    {
      // PV: thread -> row i, head hh, 16 of its 32 dims
      const int i = threadIdx.x >> 2;
      const int hh = (threadIdx.x >> 1) & 1;
      const int d0 = (threadIdx.x & 1) * 16;
      const float* p = ss + hh * S_HEAD + i * LDS;
      const float* v = sqkv + hh * 96 + 2 * DP + d0;
      float acc[16];
#pragma unroll
      for (int d = 0; d < 16; ++d) acc[d] = 0.f;
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        const float pj = p[j];
#pragma unroll
        for (int d = 0; d < 16; ++d) acc[d] = fmaf(pj, v[j * LDQ + d], acc[d]);
      }
      float* o = so + i * LDO + (2 * hp + hh) * DP + d0;
#pragma unroll
      for (int d = 0; d < 16; ++d) o[d] = rnd<T>(acc[d]);
    }
    __syncthreads();
  }

  // proj over the 6 heads' outputs (K = 6 x 32)
  if constexpr (MLP) {
    gemm64x192<T, HEADS * DP>(so, LDO, wo, CP, 0,
                              [&](int r, int n, float v) {
                                if (n < C)
                                  sx[r * LDX + n] =
                                      sx[r * LDX + n] + v + __ldg(bo + n);
                              });
  } else {
    gemm64x192<T, HEADS * DP>(so, LDO, wo, CP, 0,
                              [&](int r, int n, float v) {
                                if (n < C)
                                  out[pix(r) + n] =
                                      from_f<T>(v + __ldg(bo + n));
                              });
    return;
  }
  __syncthreads();
  layer_norm<T>(sx, sln, g2, b2);
  __syncthreads();
#pragma unroll 1
  for (int n0 = 0; n0 < HP; n0 += 192) {
    gemm64x192<T, C>(sln, LDX, w1, HP, n0, [&](int r, int n, float v) {
      if (n < HID)
        sh[r * LDH + n] = rnd<T>(gelu<T>(rnd<T>(v + __ldg(bf1 + n))));
    });
  }
  __syncthreads();
  gemm64x192<T, HID>(sh, LDH, w2, CP, 0, [&](int r, int n, float v) {
    if (n < C)
      out[pix(r) + n] = from_f<T>(sx[r * LDX + n] + (v + __ldg(bf2 + n)));
  });
}

template <typename T, bool MLP>
int launch(const void* const* p, int B, int H, int W, int shift,
           cudaStream_t stream) {
  // set on every launch, so that it holds on whichever device is current
  const cudaError_t e = cudaFuncSetAttribute(
      swin_kernel<T, MLP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long windows = (long long)B * (H / WIN) * (W / WIN);
  if (windows <= 0 || windows > 0x7fffffffLL || H % WIN || W % WIN ||
      shift < 0 || shift >= WIN)
    return (int)cudaErrorInvalidValue;
  swin_kernel<T, MLP><<<(unsigned)windows, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(p[0]), static_cast<T*>(const_cast<void*>(p[1])),
      static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const float*>(p[7]),
      static_cast<const float*>(p[8]), static_cast<const float*>(p[9]),
      static_cast<const float*>(p[10]), static_cast<const float*>(p[11]),
      static_cast<const T*>(p[12]), static_cast<const float*>(p[13]),
      static_cast<const T*>(p[14]), static_cast<const float*>(p[15]), H, W,
      shift);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, H, W, 180) contiguous, float32 (dtype 0) or bfloat16 (1),
// H and W multiples of 8. Tables (ops/window_attention.py::
// build_block_tables): g1, b1, g2, b2 (180) and bqkv (576), bo (192),
// bf1 (384), bf2 (192) float32; wqkv (180, 576), wo (192, 192),
// w1 (180, 384), w2 (360, 192) in the storage type; bias (6, 64, 64) and
// masks (4, 64, 64) float32. mlp: 1 = whole Swin block, 0 = attention
// only. Returns the CUDA error code of the launch (0 = success).
extern "C" int s2sr_swin_forward(
    const void* x, void* out, const void* g1, const void* b1,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* bias, const void* masks, const void* g2, const void* b2,
    const void* w1, const void* bf1, const void* w2, const void* bf2, int B,
    int H, int W, int shift, int dtype, int mlp, void* stream) {
  const void* p[16] = {x,  out,   g1, b1, wqkv, bqkv, wo,  bo,
                       bias, masks, g2, b2, w1,   bf1,  w2, bf2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mlp ? launch<float, true>(p, B, H, W, shift, st)
               : launch<float, false>(p, B, H, W, shift, st);
  if (dtype == 1)
    return mlp ? launch<__nv_bfloat16, true>(p, B, H, W, shift, st)
               : launch<__nv_bfloat16, false>(p, B, H, W, shift, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared-memory bytes per block (both dtypes, both modes).
extern "C" long long s2sr_swin_smem_bytes() { return (long long)SMEM_BYTES; }

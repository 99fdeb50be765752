// Swin block and window attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of s2sr_tpu/ops/pallas/window_attention.py:
//   - swin_block_fused (body _block_kernel): the whole Swin block,
//       y   = x + proj(attn(LN1(x)))
//       out = y + fc2(gelu(fc1(LN2(y))))
//   - window_attention_fused (body _attn_kernel): LN1 -> attention -> proj,
//     written without the residual (the caller adds it and runs the MLP).
// Each kernel below has a flag MLP that picks the whole block.
//
// The configuration is SwinIR-M's (both registry SwinIR models): C = 180,
// 6 heads of 30 (padded to 32 with zero weight columns, as the TPU tables
// are), window 8 (64 tokens), MLP hidden 360. Attention runs over plain
// 8x8 windows; the TPU kernel's window pairs only filled its 128-lane MXU.
// A shifted block works in the space rolled by -shift: the kernels fold
// the roll into their addressing, reading and writing each token at its
// own place in the unrolled map, and add one of 4 shift masks (0/-100)
// chosen by 2*(last window row) + (last window column) of the rolled grid.
// On a band of H (the sp axis, parallel/spatial.py) the caller rolls H
// across the bands before and after the launch; the kernel then rolls W
// alone (hshift 0) and gives the last-row mask only to the window row
// that is the whole image's last (last_wy; -1 on every band but the last).
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
// Both kernels keep everything between x and out in shared memory, so
// their time is their arithmetic, and stream the ~0.5 MB of weights of a
// block from L2, which all windows share.
//
// - bfloat16 (the serving type), swin_tc_kernel below: every product on
//   the tensor cores (mma.sync.m16n8k16, float32 accumulators), attention
//   in registers; 111,616 B of shared memory, two blocks per SM.
// - float32, swin_kernel: float32 FMA on the CUDA cores (the tensor cores
//   would make it TF32), one 256-thread block per window. Shared memory
//   (float32, 225,152 bytes, one block per SM):
//     X   64 x 180   x, then y in place
//     LN  64 x 180   LN1 output, then LN2 output
//     R   attention phase: QKV of two heads (64 x 193), their scores
//         (2 x 64 x 65), the 6 heads' outputs O (64 x 196);
//         MLP phase: the GELU'd hidden H (64 x 360)
//   Matrix products C[64 x 192] += A[64 x K] (shared) * W[K x 192]
//   (global, read through L1): thread (ry, cx) owns rows ry + 16i (i < 4)
//   and columns 12cx..12cx+11, 48 accumulators; per k it loads 4 values of
//   A and 12 of W for 48 FMAs. Row strides are odd or 4 mod 32 so that the
//   two rows a warp reads, and the per-row reads of the score and PV
//   loops, hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

// 12 consecutive float weights, 16-byte aligned
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
            int H, int W, int shift, int hshift, int last_wy) {
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
      shift > 0 ? masks + (2 * (wy == last_wy) + (wx == nww - 1)) * N * N
                : nullptr;
  // element offset of token r (row-major in the rolled window) in x/out
  auto pix = [&](int r) -> size_t {
    const int gy = (wy * WIN + (r >> 3) + hshift) % H;
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

constexpr size_t F32_SMEM = SMEM_BYTES;

// --- bf16: the tensor cores -------------------------------------------------
//
// One 256-thread block per window, two blocks per SM. Every product is
// mma.sync.m16n8k16 (bf16 in, float32 accumulators). Route: mma.sync with
// A from shared memory by ldmatrix rather than wgmma. Each product's A
// operand is written by the kernel itself (LN outputs, head outputs O,
// the GELU'd hidden H), so either instruction could read it; mma.sync
// needs no descriptors, lets one warp own 16 query rows of a head for its
// whole attention (its accumulators become the next product's A
// fragments), and runs the pattern rdb_tc_kernel already runs on the
// card. wgmma is the next step (64-row tiles are exactly one window).
//
// Shared memory (bytes; bf16 buffers are row-major with 16-byte chunk q
// stored at q ^ ((q >> 3) & 7) in its 128-byte line, so that the 8 rows
// of an ldmatrix phase hit 8 different chunks):
//   Y   0        f32 64 x 180: x, then y = x + attention (the residual)
//   LN  46,080   bf16 64 x 192: LN1 output, then LN2 output (cols 180.. 0)
//   KV  70,656   bf16 K and V of two heads, 64 x 32 each
//   O   87,040   bf16 64 x 192: the 6 heads' outputs (x is staged here
//                first, raw, 360 bytes a token)
//   H   70,656   MLP phase, over KV and O: half the GELU'd hidden, 64 x 192
// 111,616 bytes; the hidden runs in two halves of 192 so that H fits.
//
// Phases (warp w of 8):
//   x by 8-byte cp.async (a token is 360 bytes, 8-byte aligned) -> LN1.
//   Per pair of heads: warp w computes q, k and v of head 2hp + w / 4 for
//     rows 16(w % 4).. (1 M tile x 12 n8 tiles, K 192); q stays in
//     registers as the A fragments of QK^T (an m16n8 accumulator pair is
//     one k16 A fragment), k and v go to KV. Then S = QK^T (16 x 64, 32
//     float32 registers), + bias + mask, the exact full-row softmax across
//     the 4 lanes of a quad, P rounded to bf16 as the A fragments of PV,
//     V by ldmatrix.trans, O rounded to bf16 into O.
//   proj, fc1, fc2: warps in a 2 x 4 grid, each 32 rows x 48 columns.
//   proj adds into Y (whole block) or writes out (attention only); fc1
//   half h writes H; fc2 half 0 adds into Y, half 1 writes out.
// Weights: the wrapper packs each matrix in the order of mma's B
// fragments (ops/window_attention.py::pack_mma_b), one 8-byte load a lane
// per n8 tile, loaded from L2 one k16 slab ahead. K pads (180 -> 192,
// 360 -> 384) are zero rows. Executed work, pads included, is 638,976
// FLOP per token, 1.132x the useful 564,480 (s2sr_swin_macs_per_window).

constexpr int TC_THREADS = 256;
constexpr int AK = CP / 8;             // 16-byte chunks a row of the A buffers
constexpr int KS_C = CP / 16;          // k16 slabs over 192
constexpr int QKV_T = 3 * DP / 8;      // n8 tiles of one head's q | k | v
constexpr int TB_Y = 0;
constexpr int TB_LN = TB_Y + N * C * 4;
constexpr int TB_KV = TB_LN + N * CP * 2;
constexpr int KV_HEAD = 2 * N * DP * 2;        // K then V of one head
constexpr int TB_O = TB_KV + 2 * KV_HEAD;
constexpr int TB_H = TB_KV;
constexpr int TC_SMEM = TB_O + N * CP * 2;
constexpr int STAGE_ROW = C * 2;               // raw x, bytes a token
static_assert(TB_LN % 128 == 0 && TB_KV % 128 == 0 && TB_O % 128 == 0,
              "buffers start on 128-byte lines");
static_assert(N * STAGE_ROW <= N * CP * 2, "x stages in O");
static_assert(TB_H + N * CP * 2 <= TC_SMEM, "H fits over KV and O");
static_assert(2 * (TC_SMEM + 1024) <= 233472, "two blocks per SM");

__device__ __forceinline__ uint32_t swz(uint32_t q) { return q ^ ((q >> 3) & 7); }

// byte address of bf16 element (row, col) of a swizzled buffer with
// `chunks` 16-byte chunks a row
__device__ __forceinline__ uint32_t elem(uint32_t base, int row, int col,
                                         int chunks) {
  return base + swz((uint32_t)(row * chunks + (col >> 3))) * 16 + (col & 7) * 2;
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void sts(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// acc[m][j] = A[16(mt0 + m) .., 0 .. 16 KS] x B (n8 tile j of the warp), A a
// swizzled bf16 buffer of AK chunks a row, B packed fragments: bp points at
// the warp's first n8 tile of slab 0, plus the lane; bstride uint2 a slab.
template <int KS, int MT, int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4],
                                          uint32_t abuf, int mt0,
                                          const uint2* __restrict__ bp,
                                          int bstride) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  uint2 bc[NT], bn[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) bc[j] = __ldg(bp + j * 32);
#pragma unroll 2
  for (int s = 0; s < KS; ++s) {
    const uint2* nx = bp + (s + 1 < KS ? s + 1 : s) * bstride;
#pragma unroll
    for (int j = 0; j < NT; ++j) bn[j] = __ldg(nx + j * 32);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int row = 16 * (mt0 + m) + (lane & 15);
      uint32_t a[4];
      ldsm(a, abuf + swz((uint32_t)(row * AK + 2 * s + (lane >> 4))) * 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(acc[m][j], a, bc[j].x, bc[j].y);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) bc[j] = bn[j];
  }
}

// LayerNorm of rows warp, warp + 8, ... into the LN buffer (bf16, cols
// 180..191 zero); a lane holds column pairs 2 lane + 64k. FROM_X: the
// source is the staged raw x, which it also writes to Y as float32.
template <bool FROM_X>
__device__ __forceinline__ void tc_layer_norm(unsigned char* smem,
                                              uint32_t sbase,
                                              const float* __restrict__ g,
                                              const float* __restrict__ b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* y = reinterpret_cast<float*>(smem + TB_Y);
  for (int r = warp; r < N; r += TC_THREADS / 32) {
    float v[3][2];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = 2 * lane + 64 * k;
      v[k][0] = v[k][1] = 0.f;
      if (c < C) {
        float2 f;
        if constexpr (FROM_X) {
          f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              smem + TB_O + r * STAGE_ROW + 2 * c));
          *reinterpret_cast<float2*>(y + r * C + c) = f;
        } else {
          f = *reinterpret_cast<const float2*>(y + r * C + c);
        }
        v[k][0] = f.x;
        v[k][1] = f.y;
      }
      s += v[k][0] + v[k][1];
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (2 * lane + 64 * k < C) {
        const float d0 = v[k][0] - mean, d1 = v[k][1] - mean;
        q += d0 * d0 + d1 * d1;
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / C + EPS);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = 2 * lane + 64 * k;
      uint32_t o = 0;
      if (c < C)
        o = pack2((v[k][0] - mean) * rstd * __ldg(g + c) + __ldg(b + c),
                  (v[k][1] - mean) * rstd * __ldg(g + c + 1) + __ldg(b + c + 1));
      sts(elem(sbase + TB_LN, r, c, AK), o);
    }
  }
}

template <bool MLP>
__global__ void __launch_bounds__(TC_THREADS, 2)
swin_tc_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
               const float* __restrict__ g1, const float* __restrict__ b1,
               const uint2* __restrict__ wqkv, const float* __restrict__ bqkv,
               const uint2* __restrict__ wo, const float* __restrict__ bo,
               const float* __restrict__ pos_bias,
               const float* __restrict__ masks,
               const float* __restrict__ g2, const float* __restrict__ b2,
               const uint2* __restrict__ w1, const float* __restrict__ bf1,
               const uint2* __restrict__ w2, const float* __restrict__ bf2,
               int H, int W, int shift, int hshift, int last_wy) {
  // named apart from swin_kernel's: extern shared arrays share one name space
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  float* y = reinterpret_cast<float*>(smem + TB_Y);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int nwh = H / WIN;
  const int nww = W / WIN;
  const int win = blockIdx.x;
  const int b = win / (nwh * nww);
  const int wy = (win / nww) % nwh;
  const int wx = win % nww;
  const float* mask =
      shift > 0 ? masks + (2 * (wy == last_wy) + (wx == nww - 1)) * N * N
                : nullptr;
  // element offset of token r (row-major in the rolled window) in x/out
  auto pix = [&](int r) -> size_t {
    const int gy = (wy * WIN + (r >> 3) + hshift) % H;
    const int gx = (wx * WIN + (r & 7) + shift) % W;
    return (((size_t)b * H + gy) * W + gx) * C;
  };

  // x: 45 8-byte copies a token into the O buffer
  for (int i = threadIdx.x; i < N * (C / 4); i += TC_THREADS) {
    const int r = i / (C / 4), c = i - r * (C / 4);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 ::"r"(sbase + TB_O + r * STAGE_ROW + 8 * c), "l"(x + pix(r) + 4 * c)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  tc_layer_norm<true>(smem, sbase, g1, b1);
  __syncthreads();

  {
    const int hw = warp >> 2, mt = warp & 3;
    const int i0 = 16 * mt + g;                 // this lane's rows i0, i0 + 8
    const uint32_t kbuf = sbase + TB_KV + hw * KV_HEAD;
    const uint32_t vbuf = kbuf + N * DP * 2;
#pragma unroll 1
    for (int hp = 0; hp < HEADS / 2; ++hp) {
      const int head = 2 * hp + hw;
      uint32_t qa[2][4];
      {
        float acc[1][QKV_T][4];
        warp_gemm<KS_C, 1, QKV_T>(acc, sbase + TB_LN, mt,
                                  wqkv + head * QKV_T * 32 + lane,
                                  QKV_N / 8 * 32);
#pragma unroll
        for (int j = 0; j < QKV_T; ++j) {
          const int n = head * 3 * DP + 8 * j + 2 * t;
          const float c0 = __ldg(bqkv + n), c1 = __ldg(bqkv + n + 1);
          const uint32_t lo = pack2(acc[0][j][0] + c0, acc[0][j][1] + c1);
          const uint32_t hi = pack2(acc[0][j][2] + c0, acc[0][j][3] + c1);
          if (j < 4) {
            // q: n8 tiles 2s, 2s + 1 are k16 slab s of QK^T's A
            qa[j >> 1][2 * (j & 1)] = lo;
            qa[j >> 1][2 * (j & 1) + 1] = hi;
          } else {
            const uint32_t buf = j < 8 ? kbuf : vbuf;
            const int d = 8 * (j & 3) + 2 * t;
            sts(elem(buf, i0, d, DP / 8), lo);
            sts(elem(buf, i0 + 8, d, DP / 8), hi);
          }
        }
      }
      __syncthreads();
      // S = q k^T: key tile n holds keys 8n + 2t (+1) of rows i0 (e 0, 1)
      // and i0 + 8 (e 2, 3)
      float sc[N / 8][4];
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        uint32_t kb[4];
        ldsm(kb, kbuf + swz((uint32_t)((8 * n + (lane & 7)) * (DP / 8)
                                       + (lane >> 3))) * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
        mma(sc[n], qa[0], kb[0], kb[1]);
        mma(sc[n], qa[1], kb[2], kb[3]);
      }
      const float* bias = pos_bias + (size_t)head * N * N;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        const int j = 8 * n + 2 * t;
        const float2 u0 = __ldg(reinterpret_cast<const float2*>(bias + i0 * N + j));
        const float2 u1 = __ldg(reinterpret_cast<const float2*>(bias + (i0 + 8) * N + j));
        sc[n][0] += u0.x;
        sc[n][1] += u0.y;
        sc[n][2] += u1.x;
        sc[n][3] += u1.y;
        if (mask) {
          const float2 k0 = __ldg(reinterpret_cast<const float2*>(mask + i0 * N + j));
          const float2 k1 = __ldg(reinterpret_cast<const float2*>(mask + (i0 + 8) * N + j));
          sc[n][0] += k0.x;
          sc[n][1] += k0.y;
          sc[n][2] += k1.x;
          sc[n][3] += k1.y;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        sc[n][0] = expf(sc[n][0] - mx0);
        sc[n][1] = expf(sc[n][1] - mx0);
        sc[n][2] = expf(sc[n][2] - mx1);
        sc[n][3] = expf(sc[n][3] - mx1);
        sum0 += sc[n][0] + sc[n][1];
        sum1 += sc[n][2] + sc[n][3];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      // O = P V: P's k16 slab s is key tiles 2s, 2s + 1; V's B fragments by
      // ldmatrix.trans (matrix i: keys 16s + 8(i & 1).., dims 8(d + i / 2)..)
      float oa[DP / 8][4];
#pragma unroll
      for (int d = 0; d < DP / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) oa[d][e] = 0.f;
#pragma unroll
      for (int s = 0; s < N / 16; ++s) {
        uint32_t pa[4];
        pa[0] = pack2(sc[2 * s][0] / sum0, sc[2 * s][1] / sum0);
        pa[1] = pack2(sc[2 * s][2] / sum1, sc[2 * s][3] / sum1);
        pa[2] = pack2(sc[2 * s + 1][0] / sum0, sc[2 * s + 1][1] / sum0);
        pa[3] = pack2(sc[2 * s + 1][2] / sum1, sc[2 * s + 1][3] / sum1);
#pragma unroll
        for (int d = 0; d < DP / 8; d += 2) {
          const int i = lane >> 3;
          uint32_t vb[4];
          ldsm_t(vb, vbuf + swz((uint32_t)((16 * s + 8 * (i & 1) + (lane & 7))
                                           * (DP / 8) + d + (i >> 1))) * 16);
          mma(oa[d], pa, vb[0], vb[1]);
          mma(oa[d + 1], pa, vb[2], vb[3]);
        }
      }
#pragma unroll
      for (int d = 0; d < DP / 8; ++d) {
        const int col = head * DP + 8 * d + 2 * t;
        sts(elem(sbase + TB_O, i0, col, AK), pack2(oa[d][0], oa[d][1]));
        sts(elem(sbase + TB_O, i0 + 8, col, AK), pack2(oa[d][2], oa[d][3]));
      }
      __syncthreads();
    }
  }

  // proj, fc1, fc2: warp (mp, nq) owns rows 32 mp .. and n8 tiles 6 nq ..
  const int mp = warp & 1, nq = warp >> 1;
  constexpr int NT = 6;
  float acc[2][NT][4];
  warp_gemm<KS_C, 2, NT>(acc, sbase + TB_O, 2 * mp, wo + nq * NT * 32 + lane,
                         CP / 8 * 32);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * (2 * mp + m) + g + 8 * h;
        const int col = 8 * (nq * NT + j) + 2 * t;
        if (col >= C) continue;
        const float v0 = acc[m][j][2 * h] , v1 = acc[m][j][2 * h + 1];
        if constexpr (MLP) {
          float2* yy = reinterpret_cast<float2*>(y + row * C + col);
          const float2 cur = *yy;
          *yy = make_float2(cur.x + v0 + __ldg(bo + col),
                            cur.y + v1 + __ldg(bo + col + 1));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + pix(row) + col) =
              __floats2bfloat162_rn(v0 + __ldg(bo + col), v1 + __ldg(bo + col + 1));
        }
      }
  if constexpr (!MLP) return;
  __syncthreads();
  tc_layer_norm<false>(smem, sbase, g2, b2);
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    __syncthreads();
    warp_gemm<KS_C, 2, NT>(acc, sbase + TB_LN, 2 * mp,
                           w1 + (CP / 8 * half + nq * NT) * 32 + lane,
                           HP / 8 * 32);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * (2 * mp + m) + g + 8 * h;
          const int col = 8 * (nq * NT + j) + 2 * t;
          const int n = CP * half + col;
          const float v0 = rnd<__nv_bfloat16>(acc[m][j][2 * h] + __ldg(bf1 + n));
          const float v1 = rnd<__nv_bfloat16>(acc[m][j][2 * h + 1] + __ldg(bf1 + n + 1));
          sts(elem(sbase + TB_H, row, col, AK),
              pack2(gelu<__nv_bfloat16>(v0), gelu<__nv_bfloat16>(v1)));
        }
    __syncthreads();
    warp_gemm<KS_C, 2, NT>(acc, sbase + TB_H, 2 * mp,
                           w2 + (KS_C * half * (CP / 8) + nq * NT) * 32 + lane,
                           CP / 8 * 32);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * (2 * mp + m) + g + 8 * h;
          const int col = 8 * (nq * NT + j) + 2 * t;
          if (col >= C) continue;
          float2* yy = reinterpret_cast<float2*>(y + row * C + col);
          const float2 cur = *yy;
          const float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
          if (half == 0) {
            *yy = make_float2(cur.x + v0, cur.y + v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out + pix(row) + col) =
                __floats2bfloat162_rn(cur.x + (v0 + __ldg(bf2 + col)),
                                      cur.y + (v1 + __ldg(bf2 + col + 1)));
          }
        }
  }
}

int check_grid(int B, int H, int W, int shift, long long* windows) {
  *windows = (long long)B * (H / WIN) * (W / WIN);
  if (*windows <= 0 || *windows > 0x7fffffffLL || H % WIN || W % WIN ||
      shift < 0 || shift >= WIN)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The kernel of (dtype, mlp), its shared memory set on it; set on every
// call, so that it holds on whichever device is current.
int prepare(int dtype, int mlp, const void** fn, int* smem) {
  const void* k = dtype == 0 ? (mlp ? (const void*)swin_kernel<float, true>
                                    : (const void*)swin_kernel<float, false>)
                             : (mlp ? (const void*)swin_tc_kernel<true>
                                    : (const void*)swin_tc_kernel<false>);
  const int bytes = dtype == 0 ? (int)F32_SMEM : TC_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  *fn = k;
  *smem = bytes;
  return (int)e;
}

}  // namespace

// x, out: (B, H, W, 180) contiguous, float32 (dtype 0) or bfloat16 (1),
// H and W multiples of 8, 16-byte aligned. Tables (ops/window_attention.py
// ::build_block_tables): g1, b1, g2, b2 (180) and bqkv (576), bo (192),
// bf1 (384), bf2 (192) float32; bias (6, 64, 64) and masks (4, 64, 64)
// float32; the matrices wqkv (180, 576), wo (192, 192), w1 (180, 384),
// w2 (360, 192) in float32, read by the float32 kernel, and their bf16 B
// fragments wqkv_mma, wo_mma, w1_mma, w2_mma (pack_mma_b), read by the
// bfloat16 kernel (the other four may be null there, and these for
// float32). mlp: 1 = whole Swin block, 0 = attention only. Returns the
// CUDA error code of the launch (0 = success).
extern "C" int s2sr_swin_forward(
    const void* x, void* out, const void* g1, const void* b1,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* bias, const void* masks, const void* g2, const void* b2,
    const void* w1, const void* bf1, const void* w2, const void* bf2,
    const void* wqkv_f, const void* wo_f, const void* w1_f, const void* w2_f,
    int B, int H, int W, int shift, int dtype, int mlp, int band,
    void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (band < 0 || band > 2) return (int)cudaErrorInvalidValue;
  // band 0: the whole image, rolled here in H and W; 1, 2: a band of H
  // already rolled in H by -shift (only W is rolled here), 2 the one that
  // holds the image's last window row
  const int hshift = band ? 0 : shift;
  const int last_wy = band == 1 ? -1 : H / WIN - 1;
  if (dtype == 1 && !(wqkv_f && wo_f && w1_f && w2_f))
    return (int)cudaErrorInvalidValue;
  long long windows;
  int rc = check_grid(B, H, W, shift, &windows);
  if (rc) return rc;
  const void* fn;
  int smem;
  rc = prepare(dtype, mlp, &fn, &smem);
  if (rc) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[10] = {
      static_cast<const float*>(g1),  static_cast<const float*>(b1),
      static_cast<const float*>(bqkv), static_cast<const float*>(bo),
      static_cast<const float*>(bias), static_cast<const float*>(masks),
      static_cast<const float*>(g2),  static_cast<const float*>(b2),
      static_cast<const float*>(bf1), static_cast<const float*>(bf2)};
  const unsigned grid = (unsigned)windows;
  if (dtype == 0) {
    auto k = mlp ? swin_kernel<float, true> : swin_kernel<float, false>;
    k<<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), f[0], f[1],
        static_cast<const float*>(wqkv), f[2], static_cast<const float*>(wo),
        f[3], f[4], f[5], f[6], f[7], static_cast<const float*>(w1), f[8],
        static_cast<const float*>(w2), f[9], H, W, shift, hshift, last_wy);
  } else {
    auto k = mlp ? swin_tc_kernel<true> : swin_tc_kernel<false>;
    k<<<grid, TC_THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        f[0], f[1], static_cast<const uint2*>(wqkv_f), f[2],
        static_cast<const uint2*>(wo_f), f[3], f[4], f[5], f[6], f[7],
        static_cast<const uint2*>(w1_f), f[8], static_cast<const uint2*>(w2_f),
        f[9], H, W, shift, hshift, last_wy);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared-memory bytes per block, by dtype (both modes).
extern "C" long long s2sr_swin_smem_bytes(int dtype) {
  return dtype == 0 ? (long long)F32_SMEM : (long long)TC_SMEM;
}

// Resident blocks per SM of the kernel of (dtype, mlp), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives it on the current
// device; negative: minus the CUDA error code.
extern "C" int s2sr_swin_blocks_per_sm(int dtype, int mlp) {
  const void* fn;
  int smem, n = 0;
  int rc = prepare(dtype, mlp, &fn, &smem);
  if (!rc)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fn, dtype == 0 ? THREADS : TC_THREADS, smem);
  return rc ? -rc : n;
}

// Multiply-adds the kernel of (dtype, mlp) executes per window, pads
// included (head_dim 30 -> 32, output columns 180 -> 192 and hidden
// 360 -> 384, and on the tensor cores K 180 -> 192 and 360 -> 384).
extern "C" long long s2sr_swin_macs_per_window(int dtype, int mlp) {
  // the CUDA cores' products run K over 180 (qkv, fc1) and 360 (fc2)
  const long long kc = dtype == 0 ? C : CP, kh = dtype == 0 ? HID : HP;
  const long long attn = N * kc * QKV_N + 2LL * HEADS * N * N * DP
                         + (long long)N * HEADS * DP * CP;
  return attn + (mlp ? N * kc * HP + N * kh * CP : 0);
}

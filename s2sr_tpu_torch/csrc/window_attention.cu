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
// The kernels keep everything between x and out on the chip (shared
// memory, and registers), so their time is their arithmetic, and stream
// the ~0.5 MB of weights of a block from L2, which all windows share.
//
// - bfloat16 (the serving type), swin_wg_kernel below: every product on
//   wgmma (float32 accumulators), two windows a block sharing every B slab,
//   B streamed by a producer warpgroup through a ring of bulk copies, A by
//   descriptor or (Q, P) from registers; 225,016 B of shared memory, one
//   block per SM, each walking window pairs.
// - bfloat16 on mma.sync, swin_tc_kernel: the design swin_wg_kernel
//   replaced (every warp loads its own B fragments from L2; 111,616 B, two
//   blocks per SM). Served by nothing: the timing baseline swin_mma
//   (ops/window_attention.py, design="mma"), kept so that one call times
//   both designs.
// - float32 (precision "float32"), swin_f32_wg_kernel below: swin_wg_kernel's
//   design in split TF32 (three TF32 wgmma products a multiply-add),
//   256 threads with no producer, two windows a block; 231,764 B.
// - float32 on the CUDA cores, swin_kernel: the design swin_f32_wg_kernel
//   replaced, one 256-thread block per window. Served by nothing: the
//   timing baseline design="ffma" of the wrappers (ops/window_attention.py),
//   kept so that one call times both. Shared memory
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

// GELU's tanh form with the hardware's tanh.approx.f32 (relative error
// under 2^-10.9, a quarter of a bf16 step): the served bf16 kernel's
__device__ __forceinline__ float gelu_approx(float h) {
  const float u = 0.7978845608028654f * (h + 0.044715f * h * h * h);
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(u));
  return 0.5f * h * (1.f + th);
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

// --- bf16 on wgmma: swin_wg_kernel, the served bf16 kernel ------------------
//
// The design of csrc/rdb.cu's wgmma kernels (rdb_wg_kernel: a producer
// warpgroup streaming B through a ring of bulk copies, consumer warpgroups
// issuing wgmma), shaped for a window. The TPU kernel holds a block's
// weights in VMEM once for 8 window pairs a grid step; swin_tc_kernel runs a
// window a block, so every window re-reads its 589,824 bytes of B fragments
// and 114,688 bytes of dense bias and mask from L2 (2.89 GB a launch at
// (1, 512, 512), as chip_smoke.py::swin_l2_bytes counts them). Here a block
// runs two windows, one on each of two consumer warpgroups (64 tokens: one
// wgmma M tile), and both read every B slab the producer brings in: half
// the L2 reads of the weights. A block walks the window pairs blockIdx.x,
// + gridDim.x, ... (one block an SM), so that the next pair's x is copied
// into shared memory while the current pair runs.
//
// B. The wrapper packs each matrix once (ops/window_attention.py::
// pack_wg_slabs) as slabs of 96 rows x 128 bytes (12,288 B) in wgmma's
// K-major layout with the 128-byte swizzle: row n is output column n0 + n,
// its 64 K values in 16-byte chunks, chunk c at c ^ (n % 8), 8-row groups
// 1024 bytes apart. A slab is one 64-wide K block of 96 columns of one
// product; the stream is in the order the consumers read it: qkv of heads
// 0..5 (3 K blocks of the head's [q|k|v] each), proj (per K block columns
// 0..95, 96..191), then per half h of the hidden fc1's quarters 2h and
// 2h + 1 (3 K blocks each) and fc2 over the half's 192 hidden rows (per K
// block two column halves): 48 slabs, the first 24 window_attention's. One
// thread of the producer warpgroup streams them, pair after pair, with
// cp.async.bulk into a ring of 6 slots, each completing on its slot's full
// mbarrier; all 256 consumer threads arrive on the slot's empty mbarrier
// once their wgmmas on it have completed. No consumer loads B. Every big
// product is m64n96k16 (one shape), 12 k-steps of one or two wgmmas, a
// k-step's B at slot + (k % 4) * 32.
//
// A. LN1, LN2, the head outputs O and the GELU'd hidden H are written by
// the consumers themselves, straight into the same K-major 128-byte-swizzle
// layout (64 rows, three 8,192-byte K blocks), and read by descriptor: no
// tap shifts here, so the descriptor route that rdb_wg_kernel rejected
// fits. Each shared store is followed by fence.proxy.async before the
// warpgroup's named barrier, so that wgmma (the async proxy) sees it.
//
// Attention in registers (FlashAttention-3's route), a head at a time. The
// qkv accumulator of a head is rounded to bf16 with its bias: q becomes the
// A fragments of S = Q K^T (a wgmma A register fragment is mma.sync's
// m16k16 A fragment, and two n8 tiles of the accumulator are one), k and v
// go to shared memory. S is m64n64k16 with B = K, K-major 128-byte swizzle,
// a key a row holding two heads ([k of an even head | k of an odd one],
// 128 bytes; an odd head's k-steps start 64 bytes in). Scores + bias + mask
// and the exact full-row softmax work on the accumulator (a row lives in
// one quad), P rounded to bf16 is the A of O = P V, m64n32k16, B = V
// MN-major (the transpose bit) with the 64-byte swizzle: V of a head is 64
// keys x 64 bytes, chunk c of key k at c ^ ((k >> 1) & 3), 8-key groups 512
// bytes apart. Head h + 1's qkv (12 wgmmas behind one fence, one commit
// group, its 3 slabs held until it completes) is issued behind head h's S;
// the ring's other three slots take head h + 2's slabs meanwhile.
//
// Bias and mask. The bias is the compact (225, 6) table (5,400 B), staged
// once a block, read at the tokens' relative offset ((yi - yj + 7) * 15 +
// xi - xj + 7, ops/window_attention.py::relative_position_index); the mask
// is its 0/-100 rule: in a window of the last window row, tokens on the two
// sides of row 8 - shift are apart, in the last column those of column
// 8 - shift. Both give the floats of build_block_tables' bias and masks.
//
// x, y and the output. x of a window is copied raw (cp.async, 8-byte
// pieces: a token is 360 bytes, 8-byte aligned) into shared memory during
// the pair before (over K and V, which are free after attention, and a
// tail), and LN1 reads it there, four rows' reductions interleaved a warp.
// y, the residual stream, lives in the consumers' accumulator registers
// from proj on (96 floats a thread for 64 x 192): x for the residual is
// copied into the LN buffer while proj runs, LN2's row statistics come
// from quad shuffles, and fc2 accumulates straight into y. The output is
// staged in the LN buffer and written a token row at a time.
//
// Shared memory (bytes, from a 1024-aligned base; wg_smem_plan):
//   ring      0        6 slots x 12,288                          73,728
//   window w  73,728 + 65,536 w (w = 0, 1):
//     LN      +0       LN1, then the residual's x, LN2, the out  24,576
//     O       +24,576  the head outputs O, then H               24,576
//     K       +49,152  K of two heads (even | odd), 128 B a key   8,192
//     V       +57,344  V of an even head, then of an odd one     8,192
//                      (K and V: the next x's tokens 0..44 after attention)
//   x tails   204,800  the next x's tokens 45..63, 6,848 a window 13,696
//   table     218,496  the bias table, [head][225] float32        5,400
//   barriers  223,896  a full and an empty mbarrier a slot          96
// 223,992 + up to 1,024 to align = 225,016 of the block's 232,448. Keeping
// y in shared memory instead (46,080 B a window) would leave no room for
// the ring; a seventh slot would make 237,304.
//
// Registers. ptxas allocates every thread the launch's 168 (65,536 / 384),
// whatever setmaxnreg grants at run time: y and a 96-column accumulator
// (192) spilled. So a slab is 96 columns wide and fc1 runs a quarter of
// the hidden at a time (y 96 + 48). Values the compiler would otherwise
// keep live across a product or the pair loop, and spill, are recomputed
// where they are used: the thread index (tidx), the bias vectors (ld2), and
// y - mean in LN2 (fence_acc).
//
// Contracts. Every window sums the same slabs in the same order with the
// same wgmma shapes, whichever consumer, block or partner computes it; an
// odd window count leaves the last pair's second consumer a valid window to
// compute again (the last one), whose stores it drops, so that no branch on
// the warpgroup surrounds a wgmma. Windows pair across images when B > 1.
// The shift roll (and hshift, last_wy for sp bands) is folded into the
// addressing as in swin_tc_kernel; each consumer takes its own window's
// mask type.
//
// Numerics as swin_tc_kernel's (this file's head), but the order of two
// float32 sums: y = (x + proj) + bo and out = (y + fc2) + bf2, fc2's
// products added into y as they come; and three float32 functions taken
// from the hardware: the softmax's exp by ex2.approx (__expf), its
// division as one reciprocal a row, GELU's tanh by tanh.approx.f32. Each
// errs by well under a bf16 step of the value it feeds (P, H), and the
// first two keep masked rows off the IEEE division's slow path.
//
// 384 threads, one block an SM; setmaxnreg gives the consumers 240
// registers a thread and the producer 24.
//
// The instance swin_wg_no_l2_kernel (never served) splits the time: its
// producer copies the first six slabs and then only re-arms each slot's
// full barrier, so the consumers run every product, in the same order, on
// whatever their slot holds, and no B comes from L2 after the first six.
// Its output has no defined value; every product still feeds it, so ptxas
// keeps them all.

constexpr int WG_WIN = 2;                      // consumer warpgroups a block
constexpr int WG_THREADS = WG_WIN * 128 + 128;  // and a producer warpgroup
constexpr int WG_NBUF = 6;
constexpr int SLAB_N = 96;                     // columns of a slab
constexpr int WG_SLAB = SLAB_N * 128;          // 96 rows x 128 bytes
constexpr int KBLK = N * 128;                  // a 64-row A buffer's K block
constexpr int ATTN_SLABS = 6 * (HEADS / 2) + 6;
constexpr int BLOCK_SLABS = ATTN_SLABS + 24;
constexpr int TABLE = (2 * WIN - 1) * (2 * WIN - 1);
constexpr int W_LN = 0, W_O = 3 * KBLK, W_K = 6 * KBLK, W_V = 7 * KBLK;
constexpr int W_BYTES = 8 * KBLK;
constexpr int WO_WIN = WG_NBUF * WG_SLAB;
// the next window's x staged raw, 360 bytes a token: tokens 0..44 over K
// and V, 45..63 in a tail of their own
constexpr int X_ROW = 2 * C;
constexpr int X_IN_KV = (2 * KBLK) / X_ROW;
constexpr int X_TAIL = ((N - X_IN_KV) * X_ROW + 15) / 16 * 16;
constexpr int WO_XT = WO_WIN + WG_WIN * W_BYTES;
constexpr int WO_TABLE = WO_XT + WG_WIN * X_TAIL;
constexpr int WO_BAR = WO_TABLE + HEADS * TABLE * 4;
constexpr int WG_SMEM = 1024 + WO_BAR + 2 * WG_NBUF * 8;
static_assert(X_IN_KV == 45 && X_TAIL == 6848, "the staging split as noted");
static_assert(WO_WIN == 73728 && WO_TABLE == 218496 && WO_BAR == 223896 &&
              WG_SMEM == 225016, "shared memory as the note counts it");
static_assert(WG_SMEM <= 232448, "over the 227 KB a block may opt into");
static_assert(WO_BAR % 8 == 0, "mbarriers 8-byte aligned");

enum WgVariant : int { WG_SERVED = 0, WG_NO_L2 = 1 };

struct SwinArgs {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  const float *g1, *b1, *bqkv, *bo, *table, *g2, *b2, *bf1, *bf2;
  const unsigned char* slabs;
  int H, W, shift, hshift, last_wy, windows;
};

// byte offset of bf16 element (row, col) of a K-major 128-byte-swizzle
// buffer (rows of 128 bytes, col < 64) and of an MN-major 64-byte-swizzle
// one (rows of 64 bytes, col < 32), from a 1024-aligned base
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}
__device__ __forceinline__ uint32_t sw64(int row, int col) {
  return row * 64 + ((((col >> 3) ^ (row >> 1)) & 3) << 4) + (col & 7) * 2;
}

// Descriptors: K-major, 128-byte swizzle (8-row groups 1024 bytes apart, the
// leading offset unused by the layout); MN-major, 64-byte swizzle (8-row
// groups along K 512 bytes apart, one 32-column atom along N)
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_mn64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)32 << 32) | ((uint64_t)2 << 62);
}

// wgmma.mma_async, float32 sums from bf16, d += A B: A by descriptor
// (m64n96k16) or from registers (m64n64k16; m64n32k16 with B MN-major)
__device__ __forceinline__ void wg_ss96(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_rs64(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_rs32t(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// Orders the accumulators around the wgmmas for the compiler, which sees no
// register operand on the fence or the wait (CUTLASS's
// warpgroup_fence_operand).
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int NA>
__device__ __forceinline__ void zero(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) d[i] = 0.f;
}
// the consumers' own shared stores made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Waits for the phase of parity `parity` of the mbarrier at `bar`, polling
// inside one asm block; a wait of 2^33 clocks (seconds) traps, so that a
// fault in the ring's bookkeeping ends the launch with an error instead of
// hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile("{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
               "mov.u64 t0, %%clock64;\n"
               "WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               "@p bra DONE;\n"
               "mov.u64 t1, %%clock64;\n"
               "sub.u64 t1, t1, t0;\n"
               "setp.lt.u64 p, t1, 8589934592;\n"
               "@p bra WAIT;\n"
               "trap;\n"
               "DONE:\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// The B ring: WG_NBUF slots of WG_SLAB bytes from 1024-aligned `slots`, a
// full and an empty mbarrier a slot. A consumer numbers the slabs of its
// current window pair from 0; `base` is the ring's count of the slabs
// before them (the pairs the block ran before, BLOCK_SLABS or ATTN_SLABS
// each, multiples of WG_NBUF).
struct WgRing {
  uint32_t slots, full, empty;
  int base;
};

__device__ __forceinline__ void slab_wait(const WgRing& r, int g) {
  g += r.base;
  mbar_wait(r.full + 8 * (g % WG_NBUF), (uint32_t)(g / WG_NBUF) & 1);
}
// this thread's wgmmas on slab g have completed
__device__ __forceinline__ void slab_release(const WgRing& r, int g) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(r.empty + 8 * ((g + r.base) % WG_NBUF)) : "memory");
}
// the shared address of slab g's slot
__device__ __forceinline__ uint32_t slab_addr(const WgRing& r, int g) {
  return r.slots + (uint32_t)((g + r.base) % WG_NBUF) * WG_SLAB;
}

// The producer's thread: the stream's n slabs once for each of the block's
// `pairs` window pairs, every slab in order, each into its slot once the
// consumers have released the slab WG_NBUF before it. WG_NO_L2 copies the
// first WG_NBUF and then re-arms the full barrier without a copy.
template <int V>
__device__ __forceinline__ void wg_produce(const WgRing& r, const unsigned char* slabs,
                                           int n, int pairs) {
  for (int g = 0; g < n * pairs; ++g) {
    const uint32_t slot = (uint32_t)(g % WG_NBUF);
    const uint32_t bar = r.full + 8 * slot;
    if (g >= WG_NBUF) mbar_wait(r.empty + 8 * slot, (uint32_t)(g / WG_NBUF - 1) & 1);
    if (V == WG_NO_L2 && g >= WG_NBUF) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
      continue;
    }
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(WG_SLAB) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 ::"r"(r.slots + slot * WG_SLAB), "l"(slabs + (size_t)(g % n) * WG_SLAB),
                   "r"(WG_SLAB), "r"(bar) : "memory");
  }
}

// acc += A B over one product of 96 NS columns: A the 64 x 192 buffer at
// `abuf` (three K blocks), B the slabs from global index g0, NS a K block
// (the accumulator's columns 96 s.. from slab g0 + NS kb + s). Per k-step
// NS wgmmas, committed, then wait_group 1, so that a step runs while the
// next is issued; the step before has then completed, and the slabs of a K
// block whose last step it was are released. Fully unrolled: no loop is
// entered with sums in flight. The accumulators of the NS slabs side by
// side are the m64n(96 NS) layout: element 4j + e, n8 tile j.
template <int NS>
__device__ __forceinline__ void wg_gemm(float (&acc)[48 * NS], uint32_t abuf,
                                        const WgRing& r, int g0) {
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const int g = g0 + NS * (k / 4);
    if (k % 4 == 0)
#pragma unroll
      for (int s = 0; s < NS; ++s) slab_wait(r, g + s);
    // every input of the wgmmas defined before the fence (ptxas C7513)
    uint64_t da = desc_k128(abuf + (k / 4) * KBLK + (k % 4) * 32);
    uint64_t db[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      db[s] = desc_k128(slab_addr(r, g + s) + (k % 4) * 32);
      asm volatile("" : "+l"(db[s])::"memory");
    }
    asm volatile("" : "+l"(da)::"memory");
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < NS; ++s) wg_ss96(acc + 48 * s, da, db[s]);
    wgmma_commit();
    wgmma_wait<1>();
    if (k % 4 == 0 && k > 0)
#pragma unroll
      for (int s = 0; s < NS; ++s) slab_release(r, g - NS + s);
  }
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int s = 0; s < NS; ++s) slab_release(r, g0 + 2 * NS + s);
}

// The thread's index, read where it is used: every per-thread address of
// the consumers derives from it, and the compiler would otherwise hoist
// them (hundreds, all the same for every window pair) out of the block's
// loop over pairs and spill them
__device__ __forceinline__ int tidx() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v));
  return v;
}

// Phase clocks, compiled only with -DS2SR_SWIN_STAMPS (chip_smoke.py's
// phase swin_numbers builds such a copy): clock64 at a window's phase
// boundaries (enum WgStamp) by the first thread of each consumer, and the
// global timer at its start and end, for window pairs 0..STAMP_PAIRS - 1,
// read back by s2sr_swin_wg_stamps. Without the macro WG_STAMP is nothing.
enum WgStamp : int {
  ST_START = 0, ST_LN1 = 1, ST_ATTN = 2, ST_PROJ = 3, ST_LN2 = 4,
  ST_FC1 = 5,      // + 2 (2h + q): fc1 quarter q of half h done
  ST_GELU = 6,     // + 2 (2h + q): its GELU stored
  ST_FC2 = 13,     // + h
  ST_OUT = 15, ST_END = 16, ST_T0 = 17, ST_T1 = 18, STAMPS = 19
};
#ifdef S2SR_SWIN_STAMPS
constexpr int STAMP_PAIRS = 4096;
__device__ long long g_stamps[STAMP_PAIRS][2][STAMPS];
__device__ __forceinline__ void wg_stamp(int pair, int k) {
  if ((tidx() & 127) == 0 && pair < STAMP_PAIRS) {
    long long v;
    if (k >= ST_T0) asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(v));
    else asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(v));
    g_stamps[pair][tidx() >> 7][k] = v;
  }
}
#define WG_STAMP(pair, k) wg_stamp(pair, k)
#else
#define WG_STAMP(pair, k) \
  do {                    \
  } while (0)
#endif

// two consecutive float32 of a vector, col even (8-byte aligned), read
// where it stands: an asm volatile load is not hoisted above the wgmmas
// and waits before it, where the compiler would hold it in registers
// across a product (and spill)
__device__ __forceinline__ float2 ld2(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}

// warp_sum of four values at once, their shuffles interleaved
__device__ __forceinline__ void warp_sum4(float (&v)[4]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] += __shfl_xor_sync(0xffffffffu, v[u], o);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// acc += A B over one product of 96 columns, issued at once: its three
// slabs from g0 waited for, 12 wgmmas into acc behind one fence (wgmmas on
// the same accumulator need none between them; a fence before each waits
// for the one before), one commit group. The caller waits for the group,
// then releases the slabs (slabs_release), so that work on other
// registers runs meanwhile.
__device__ __forceinline__ void wg_issue(float (&acc)[48], uint32_t abuf, const WgRing& r,
                                         int g0) {
#pragma unroll
  for (int s = 0; s < 3; ++s) slab_wait(r, g0 + s);
  uint64_t da[12], db[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    da[k] = desc_k128(abuf + (k / 4) * KBLK + (k % 4) * 32);
    db[k] = desc_k128(slab_addr(r, g0 + k / 4) + (k % 4) * 32);
    asm volatile("" : "+l"(da[k]), "+l"(db[k])::"memory");
  }
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 12; ++k) wg_ss96(acc, da[k], db[k]);
  wgmma_commit();
}
__device__ __forceinline__ void slabs_release(const WgRing& r, int g0) {
#pragma unroll
  for (int s = 0; s < 3; ++s) slab_release(r, g0 + s);
}

// Head h's qkv accumulator (columns [q|k|v] of 32, n8 tiles 0-3, 4-7,
// 8-11) + bias, rounded to bf16: q into S's A fragments (n8 tiles 2s,
// 2s + 1 are k16 slab s), k into K's 64-byte half h % 2 (keys a row), v
// into V buffer h % 2.
__device__ __forceinline__ void qkv_epilogue(const float (&acc)[48], const float* bqkv,
                                             int h, uint32_t kb, uint32_t vb,
                                             uint32_t (&qa)[2][4]) {
  const int lane = tidx() & 31, t = lane & 3;
  const int r0 = 16 * ((tidx() >> 5) & 3) + (lane >> 2), r1 = r0 + 8;
  const int par = h & 1;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float2 c = ld2(bqkv + 96 * h + 8 * j + 2 * t);
    const uint32_t lo = pack2(acc[4 * j] + c.x, acc[4 * j + 1] + c.y);
    const uint32_t hi = pack2(acc[4 * j + 2] + c.x, acc[4 * j + 3] + c.y);
    if (j < 4) {
      qa[j >> 1][2 * (j & 1)] = lo;
      qa[j >> 1][2 * (j & 1) + 1] = hi;
    } else if (j < 8) {
      const int d = 32 * par + 8 * (j - 4) + 2 * t;
      sts(kb + sw128(r0, d), lo);
      sts(kb + sw128(r1, d), hi);
    } else {
      const int d = 8 * (j - 8) + 2 * t;
      sts(vb + par * (N * 64) + sw64(r0, d), lo);
      sts(vb + par * (N * 64) + sw64(r1, d), hi);
    }
  }
}

// Head h: S = q k^T (2 wgmmas, A = q from registers) committed; with NEXT,
// head h + 1's qkv issued behind it; the scores + bias + mask and the
// softmax while those run; O = P V (4 wgmmas, A = P); O rounded to bf16
// into K block h / 2 of O; with NEXT, head h + 1's epilogue.
template <bool NEXT>
__device__ __forceinline__ void wg_head(const SwinArgs& a, const WgRing& ring, uint32_t ln,
                                        uint32_t ob, uint32_t kb, uint32_t vb,
                                        const float* tb, int h, bool lr, bool lc,
                                        float (&acc)[48], uint32_t (&qa)[2][4], int wg) {
  const int warp = (tidx() >> 5) & 3, lane = tidx() & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int par = h & 1, shift = a.shift;
  // S: key tile n holds keys 8n + 2t (+1) of rows r0, r1
  float sc[32];
  zero(sc);
  {
    uint64_t d0 = desc_k128(kb + 64 * par), d1 = desc_k128(kb + 64 * par + 32);
    asm volatile("" : "+l"(d0), "+l"(d1)::"memory");
    fence_acc(sc);
    wgmma_fence();
    wg_rs64(sc, qa[0], d0);
    wg_rs64(sc, qa[1], d1);
    wgmma_commit();
  }
  if constexpr (NEXT) {
    zero(acc);
    wg_issue(acc, ln, ring, 3 * (h + 1));
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_acc(sc);
  // + bias + mask (row i = 8 yi + xi: yi = 2 warp + e / 2, xi = g; key
  // j = 8n + 2t + e % 2: yj = n, xj = 2t + e % 2), then the softmax
  const float* bias = tb + h * TABLE;
  const int edge = WIN - shift;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int yi = 2 * warp + (e >> 1), xi = g, yj = n, xj = 2 * t + (e & 1);
      float v = sc[4 * n + e] + bias[(yi - yj + WIN - 1) * (2 * WIN - 1) + xi - xj + WIN - 1];
      if (shift > 0) {
        const bool apart = (lr && ((yi >= edge) != (yj >= edge))) ||
                           (lc && ((xi >= edge) != (xj >= edge)));
        v += apart ? -100.f : 0.f;
      }
      sc[4 * n + e] = v;
      if (e < 2) mx0 = fmaxf(mx0, v);
      else mx1 = fmaxf(mx1, v);
    }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  // exp by ex2.approx (__expf), the row's sum inverted once: masked terms
  // are denormal (e^-100), where an IEEE division per term takes its slow
  // path
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    sc[4 * n] = __expf(sc[4 * n] - mx0);
    sc[4 * n + 1] = __expf(sc[4 * n + 1] - mx0);
    sc[4 * n + 2] = __expf(sc[4 * n + 2] - mx1);
    sc[4 * n + 3] = __expf(sc[4 * n + 3] - mx1);
    sum0 += sc[4 * n] + sc[4 * n + 1];
    sum1 += sc[4 * n + 2] + sc[4 * n + 3];
  }
  const float inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
  // P rounded to bf16 as PV's A: k16 slab s is key tiles 2s, 2s + 1
  uint32_t pa[N / 16][4];
#pragma unroll
  for (int s = 0; s < N / 16; ++s) {
    pa[s][0] = pack2(sc[8 * s] * inv0, sc[8 * s + 1] * inv0);
    pa[s][1] = pack2(sc[8 * s + 2] * inv1, sc[8 * s + 3] * inv1);
    pa[s][2] = pack2(sc[8 * s + 4] * inv0, sc[8 * s + 5] * inv0);
    pa[s][3] = pack2(sc[8 * s + 6] * inv1, sc[8 * s + 7] * inv1);
  }
  // O = P V: B = V (keys 16s.. at 1024 s), MN-major
  float oa[16];
  zero(oa);
  {
    uint64_t dv[N / 16];
#pragma unroll
    for (int s = 0; s < N / 16; ++s) dv[s] = desc_mn64(vb + par * (N * 64) + s * 1024);
    asm volatile("" : "+l"(dv[0]), "+l"(dv[1]), "+l"(dv[2]), "+l"(dv[3])::"memory");
    fence_acc(oa);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < N / 16; ++s) wg_rs32t(oa, pa[s], dv[s]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(oa);
  }
  if constexpr (NEXT) {
    fence_acc(acc);
    slabs_release(ring, 3 * (h + 1));
  }
  // O rounded to bf16: head h's 32 columns are K block h / 2, 32 (h % 2)..
#pragma unroll
  for (int d = 0; d < DP / 8; ++d) {
    const int col = 32 * par + 8 * d + 2 * t;
    sts(ob + (h >> 1) * KBLK + sw128(r0, col), pack2(oa[4 * d], oa[4 * d + 1]));
    sts(ob + (h >> 1) * KBLK + sw128(r1, col), pack2(oa[4 * d + 2], oa[4 * d + 3]));
  }
  if constexpr (NEXT) {
    // the next head's k and v go to the other halves, which its S and PV
    // read after the barrier
    qkv_epilogue(acc, a.bqkv, h + 1, kb, vb, qa);
    fence_async();
    wg_sync(wg);
  }
}

// The window's output: bf16(acc + bias) for the 180 columns, staged in the
// LN buffer as 64 tokens x 360 bytes, then written a token row at a time
// in 8-byte pieces (a warp's 32 lanes 256 contiguous bytes), instead of
// each thread's 8 scattered 16-byte pieces a store. Not where `valid` is
// false (the duplicate window of an odd count).
template <typename Pix>
__device__ __forceinline__ void wg_store(const SwinArgs& a, uint32_t stage, Pix pix,
                                         const float (&acc)[96], const float* bias,
                                         bool valid, int wg) {
  const int tid = tidx() & 127, lane = tid & 31, t = lane & 3;
  const int r0 = 16 * (tid >> 5) + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= C) continue;
    const float2 c = ld2(bias + col);
    sts(stage + r0 * (2 * C) + 2 * col, pack2(acc[4 * j] + c.x, acc[4 * j + 1] + c.y));
    sts(stage + r1 * (2 * C) + 2 * col, pack2(acc[4 * j + 2] + c.x, acc[4 * j + 3] + c.y));
  }
  wg_sync(wg);
  if (valid) {
    for (int i = tid; i < N * (C / 4); i += 128) {
      const int r = i / (C / 4), c = i - r * (C / 4);
      uint2 v;
      asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y)
                   : "r"(stage + r * (2 * C) + 8 * c));
      *reinterpret_cast<uint2*>(a.out + pix(r) + 4 * c) = v;
    }
  }
  // the next window's LN1 writes this buffer
  wg_sync(wg);
}

// fc1's 96 columns c0.. of the half (acc, m64n96) + bias, rounded to bf16,
// through GELU, rounded again, into H (the O buffer's K blocks)
__device__ __forceinline__ void gelu_store(const float (&f)[48], const float* bf1,
                                           uint32_t ob, int c0) {
  const int lane = tidx() & 31, t = lane & 3;
  const int r0 = 16 * ((tidx() >> 5) & 3) + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    const float2 c = ld2(bf1 + col);
    const float v0 = rnd<__nv_bfloat16>(f[4 * j] + c.x);
    const float v1 = rnd<__nv_bfloat16>(f[4 * j + 1] + c.y);
    const float v2 = rnd<__nv_bfloat16>(f[4 * j + 2] + c.x);
    const float v3 = rnd<__nv_bfloat16>(f[4 * j + 3] + c.y);
    sts(ob + (col >> 6) * KBLK + sw128(r0, col & 63), pack2(gelu_approx(v0), gelu_approx(v1)));
    sts(ob + (col >> 6) * KBLK + sw128(r1, col & 63), pack2(gelu_approx(v2), gelu_approx(v3)));
  }
}

// A window's place: its image, window row and column.
struct WinPos {
  int b, wy, wx;
};
template <typename A>
__device__ __forceinline__ WinPos win_pos(const A& a, int win) {
  const int nwh = a.H / WIN, nww = a.W / WIN;
  return {win / (nwh * nww), (win / nww) % nwh, win % nww};
}
// element offset of token r (row-major in the rolled window) of window p in
// x / out; the rolled place is under 2H (2W), so one subtraction wraps it
template <typename A>
__device__ __forceinline__ size_t token(const A& a, const WinPos& p, int r) {
  int gy = p.wy * WIN + (r >> 3) + a.hshift;
  int gx = p.wx * WIN + (r & 7) + a.shift;
  gy -= gy >= a.H ? a.H : 0;
  gx -= gx >= a.W ? a.W : 0;
  return (((size_t)p.b * a.H + gy) * a.W + gx) * C;
}

// Shared address of token r's raw x in window wg's staging (over K and V,
// then the tail)
__device__ __forceinline__ uint32_t x_stage(uint32_t sbase, int wg, int r) {
  return r < X_IN_KV ? sbase + WO_WIN + wg * W_BYTES + W_K + r * X_ROW
                     : sbase + WO_XT + wg * X_TAIL + (r - X_IN_KV) * X_ROW;
}
// cp.async of a token row (360 bytes, 8-byte aligned) by a warp, 8-byte
// pieces, the lanes on consecutive ones (256 bytes an instruction)
__device__ __forceinline__ void copy_row(uint32_t dst, const __nv_bfloat16* src) {
  const int lane = tidx() & 31;
#pragma unroll
  for (int c = lane; c < C / 4; c += 32)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 ::"r"(dst + 8 * c), "l"(src + 4 * c) : "memory");
}
// window p's x into the staging, a warp the rows warp + 4i; the caller
// commits
__device__ __forceinline__ void stage_x(const SwinArgs& a, uint32_t sbase, int wg,
                                        const WinPos& p) {
  const int warp = (tidx() >> 5) & 3;
#pragma unroll 4
  for (int r = warp; r < N; r += 4) copy_row(x_stage(sbase, wg, r), a.x + token(a, p, r));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One consumer warpgroup: window 2 pair + wg. Thread (warp, g, t) holds
// accumulator rows r0 = 16 warp + g and r1 = r0 + 8, and of each n8 tile j
// the columns 8j + 2t, +1: element 4j + e is row r0 (e < 2) or r1, column
// 8j + 2t + (e & 1).
template <bool MLP>
__device__ __forceinline__ void wg_window(const SwinArgs& a, const WgRing& ring,
                                          uint32_t sbase, const float* tb, int pair) {
  const int wg = tidx() >> 7, tid = tidx() & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  int win = 2 * pair + wg;
  const bool valid = win < a.windows;
  if (!valid) win = a.windows - 1;        // computed again, stores dropped
  const int shift = a.shift;
  const WinPos wp = win_pos(a, win);
  const bool lr = shift > 0 && wp.wy == a.last_wy;
  const bool lc = shift > 0 && wp.wx == a.W / WIN - 1;
  auto pix = [&](int r) -> size_t { return token(a, wp, r); };
  const uint32_t wbase = sbase + WO_WIN + wg * W_BYTES;
  const uint32_t ln = wbase + W_LN, ob = wbase + W_O, kb = wbase + W_K, vb = wbase + W_V;

  // LN1 from the staged x (copied during the pair before, or at the
  // block's first pair now): a warp the rows warp + 4i, a lane the column
  // pairs 2 lane + 64 k (K block k)
  WG_STAMP(pair, ST_START);
  WG_STAMP(pair, ST_T0);
  if (pair == (int)blockIdx.x) {
    stage_x(a, sbase, wg, wp);
    cp_commit();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  wg_sync(wg);
  {
    uint32_t xv[N / 4][3];
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint32_t row = x_stage(sbase, wg, warp + 4 * i);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int c = 2 * lane + 64 * k;
        xv[i][k] = 0u;
        if (c < C)
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(xv[i][k]) : "r"(row + 2 * c));
      }
    }
    float2 gg[3], bb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = 2 * lane + 64 * k;
      gg[k] = c < C ? ld2(a.g1 + c) : make_float2(0.f, 0.f);
      bb[k] = c < C ? ld2(a.b1 + c) : make_float2(0.f, 0.f);
    }
    // four rows at a time, their shuffle reductions interleaved
#pragma unroll
    for (int i0 = 0; i0 < N / 4; i0 += 4) {
      float v[4][3][2], s[4], q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s[u] = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xv[i0 + u][k]));
          v[u][k][0] = f.x;
          v[u][k][1] = f.y;
          s[u] += f.x + f.y;
        }
      }
      warp_sum4(s);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s[u] /= C;
        q[u] = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (2 * lane + 64 * k < C) {
            const float d0 = v[u][k][0] - s[u], d1 = v[u][k][1] - s[u];
            q[u] += d0 * d0 + d1 * d1;
          }
        }
      }
      warp_sum4(q);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = warp + 4 * (i0 + u);
        const float rstd = rsqrtf(q[u] / C + EPS);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const uint32_t o = 2 * lane + 64 * k < C
              ? pack2((v[u][k][0] - s[u]) * rstd * gg[k].x + bb[k].x,
                      (v[u][k][1] - s[u]) * rstd * gg[k].y + bb[k].y)
              : 0u;
          sts(ln + k * KBLK + sw128(r, 2 * lane), o);
        }
      }
    }
  }
  fence_async();
  wg_sync(wg);
  WG_STAMP(pair, ST_LN1);

  // attention, a head at a time: head h + 1's qkv runs on the tensor cores
  // while head h's softmax runs on the CUDA cores
  uint32_t qa[2][4];
  float acc[48];
  zero(acc);
  wg_issue(acc, ln, ring, 0);
  wgmma_wait<0>();
  fence_acc(acc);
  slabs_release(ring, 0);
  qkv_epilogue(acc, a.bqkv, 0, kb, vb, qa);
  fence_async();
  wg_sync(wg);
#pragma unroll 1
  for (int h = 0; h < HEADS - 1; ++h)
    wg_head<true>(a, ring, ln, ob, kb, vb, tb, h, lr, lc, acc, qa, wg);
  wg_head<false>(a, ring, ln, ob, kb, vb, tb, HEADS - 1, lr, lc, acc, qa, wg);
  fence_async();
  wg_sync(wg);
  WG_STAMP(pair, ST_ATTN);

  // x again for the residual: 8-byte copies into the LN buffer (free once
  // the last qkv completed) while proj runs, a token 360 bytes
  if constexpr (MLP) {
#pragma unroll 4
    for (int r = warp; r < N; r += 4) copy_row(ln + r * X_ROW, a.x + pix(r));
    cp_commit();
  }
  // the block's next window pair: its x into the staging (K and V are free
  // now), ready for its LN1; a group of its own, empty after the last pair,
  // so that waiting for all but one group waits for the residual
  {
    const int np = pair + (int)gridDim.x;
    if (np < (a.windows + 1) / 2) {
      const int nw = 2 * np + wg;
      stage_x(a, sbase, wg, win_pos(a, nw < a.windows ? nw : a.windows - 1));
    }
    cp_commit();
  }
  // proj over the 6 heads' outputs (K = 192); y = (x + proj) + bo
  float y[96];
  zero(y);
  wg_gemm<2>(y, ob, ring, 3 * HEADS);
  WG_STAMP(pair, ST_PROJ);
  if constexpr (!MLP) {
    WG_STAMP(pair, ST_OUT);
    wg_store(a, ln, pix, y, a.bo, valid, wg);
    WG_STAMP(pair, ST_END);
    WG_STAMP(pair, ST_T1);
    return;
  }
  // the residual's group; the next pair's may still run
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  wg_sync(wg);
  {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < C) {
        const float2 c = ld2(a.bo + col);
        uint32_t xa, xb;
        asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(xa) : "r"(ln + r0 * (2 * C) + 2 * col));
        asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(xb) : "r"(ln + r1 * (2 * C) + 2 * col));
        const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa));
        const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xb));
        y[4 * j] = (x0.x + y[4 * j]) + c.x;
        y[4 * j + 1] = (x0.y + y[4 * j + 1]) + c.y;
        y[4 * j + 2] = (x1.x + y[4 * j + 2]) + c.x;
        y[4 * j + 3] = (x1.y + y[4 * j + 3]) + c.y;
        s0 += y[4 * j] + y[4 * j + 1];
        s1 += y[4 * j + 2] + y[4 * j + 3];
      } else {
        y[4 * j] = y[4 * j + 1] = y[4 * j + 2] = y[4 * j + 3] = 0.f;
      }
    }
    // LN2 from the registers: row statistics over the quad
    const float mean0 = quad_sum(s0) / C, mean1 = quad_sum(s1) / C;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      if (8 * j + 2 * t < C) {
        const float d0 = y[4 * j] - mean0, d1 = y[4 * j + 1] - mean0;
        const float d2 = y[4 * j + 2] - mean1, d3 = y[4 * j + 3] - mean1;
        q0 += d0 * d0 + d1 * d1;
        q1 += d2 * d2 + d3 * d3;
      }
    }
    const float rstd0 = rsqrtf(quad_sum(q0) / C + EPS);
    const float rstd1 = rsqrtf(quad_sum(q1) / C + EPS);
    // y - mean again below, not kept from the loop above: 96 more live
    // floats beside y spill
    fence_acc(y);
    // LN2 overwrites the staged x the other warps read
    wg_sync(wg);
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = 8 * j + 2 * t;
      uint32_t o0 = 0, o1 = 0;
      if (col < C) {
        const float2 gv = ld2(a.g2 + col), bv = ld2(a.b2 + col);
        o0 = pack2((y[4 * j] - mean0) * rstd0 * gv.x + bv.x,
                   (y[4 * j + 1] - mean0) * rstd0 * gv.y + bv.y);
        o1 = pack2((y[4 * j + 2] - mean1) * rstd1 * gv.x + bv.x,
                   (y[4 * j + 3] - mean1) * rstd1 * gv.y + bv.y);
      }
      sts(ln + (j >> 3) * KBLK + sw128(r0, col & 63), o0);
      sts(ln + (j >> 3) * KBLK + sw128(r1, col & 63), o1);
    }
  }
  fence_async();
  wg_sync(wg);
  WG_STAMP(pair, ST_LN2);
  // the MLP in two halves of the hidden: fc1 half h, a quarter of 96
  // columns at a time, into H (over O), then fc2 over those 192 hidden
  // columns, added into y
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
#pragma unroll 1
    for (int q = 0; q < 2; ++q) {
      float f[48];
      zero(f);
      wg_gemm<1>(f, ln, ring, ATTN_SLABS + 12 * h + 3 * q);
      WG_STAMP(pair, ST_FC1 + 2 * (2 * h + q));
      gelu_store(f, a.bf1 + 192 * h, ob, 96 * q);
      WG_STAMP(pair, ST_GELU + 2 * (2 * h + q));
    }
    fence_async();
    wg_sync(wg);
    wg_gemm<2>(y, ob, ring, ATTN_SLABS + 12 * h + 6);
    WG_STAMP(pair, ST_FC2 + h);
    // the next half's H overwrites this one
    wg_sync(wg);
  }
  WG_STAMP(pair, ST_OUT);
  wg_store(a, ln, pix, y, a.bf2, valid, wg);
  WG_STAMP(pair, ST_END);
  WG_STAMP(pair, ST_T1);
}

// The body: the ring's barriers and the bias table, then the roles.
template <bool MLP, int V>
__device__ __forceinline__ void wg_body(const SwinArgs& a) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(wg_smem);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  unsigned char* base = wg_smem + (sbase - raw);
  WgRing ring;
  ring.slots = sbase;
  ring.full = sbase + WO_BAR;
  ring.empty = ring.full + 8 * WG_NBUF;
  ring.base = 0;
  float* tb = reinterpret_cast<float*>(base + WO_TABLE);
  if (threadIdx.x == 0) {
    for (int i = 0; i < WG_NBUF; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(ring.full + 8 * i) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   ::"r"(ring.empty + 8 * i), "r"(WG_WIN * 128) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the bias table, [head][225]
  for (int i = threadIdx.x; i < HEADS * TABLE; i += WG_THREADS)
    tb[i] = __ldg(a.table + (i % TABLE) * HEADS + i / TABLE);
  __syncthreads();
  // the roles, read warp-uniform, in one if-else that never rejoins, so
  // that setmaxnreg holds: warpgroups 0 and 1 consume with 240 registers a
  // thread, warpgroup 2 gives its registers down to 24 and its first thread
  // produces
  // the block walks the window pairs blockIdx.x, + gridDim.x, ...
  constexpr int n = MLP ? BLOCK_SLABS : ATTN_SLABS;
  const int pairs = (a.windows + 1) / 2;
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == WG_WIN) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == WG_WIN * 128)
      wg_produce<V>(ring, a.slabs, n,
                    (pairs - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
#pragma unroll 1
    for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
      wg_window<MLP>(a, ring, sbase, tb, p);
      ring.base += n;
    }
  }
}

template <bool MLP>
__global__ void __launch_bounds__(WG_THREADS, 1) swin_wg_kernel(const SwinArgs a) {
  wg_body<MLP, WG_SERVED>(a);
}

// the time-attribution instance (never served): B from L2 only for the
// first six slabs
__global__ void __launch_bounds__(WG_THREADS, 1) swin_wg_no_l2_kernel(const SwinArgs a) {
  wg_body<true, WG_NO_L2>(a);
}

// --- float32 on wgmma: swin_f32_wg_kernel, split TF32 ------------------------
//
// The served float32 kernel (SwinIR at precision "float32"): both TPU
// kernels of this file's head (swin_block_fused, MLP true;
// window_attention_fused, MLP false) for float32 storage, replacing
// swin_kernel<float, MLP>, the CUDA-core design, which stays as the
// never-served timing baseline design="ffma". The shift roll, hshift and
// last_wy (sp bands) are folded into the addressing, the bias is the
// compact (225, 6) table and the mask its 0/-100 rule, all as
// swin_wg_kernel has them.
//
// Numerics (this file's head, float32 storage): LayerNorm
// statistics, scores + bias + mask and the softmax in float32 (expf, one
// IEEE reciprocal a row), GELU in the exact erff form, y, the residual
// stream, in float32; nothing rounded below float32. The products run on
// the tensor cores, which take float32 only as TF32 (10 stored mantissa
// bits), in split TF32 ("3xTF32", csrc/rdb.cu's rdb_f32_wg_kernel): each
// operand v becomes hi = rna(v) and lo = rna(v - hi) (tf32_rna: an integer
// add and mask, bit-equal to cvt.rna.tf32, which issues at a quarter
// rate), and every multiply-add is three wgmma.m64nNk8.f32.tf32.tf32
// products, lo_a hi_b, hi_a lo_b, hi_a hi_b; lo_a lo_b is dropped. The
// tensor cores truncate where they add a product sum to an accumulator,
// so a product runs into partial sums of its own (the first wgmma with
// scale-d 0) over at most one K block of 32 (12 sums; fc2's 96-row
// quarter 36) and the partials are folded into the float32 sums by
// rounded adds (__fadd_rn): qkv and fc1 a K block at a time, proj a head
// at a time and fc2 a hidden quarter at a time into y.
//
// What bounds it: operations. 564,480 useful FLOP a token at 495 TFLOP/s
// of TF32 for three products: 0.897 ms at (1, 512, 512); as executed (the
// pads: head dim 32, C 192, hidden 384; 20,447,232 multiply-adds a
// window) 1.015 ms; at 67 TFLOP/s of FP32 FMA (swin_kernel<float, MLP>'s
// route, the CUDA-core design this replaces, kept as the never-served
// timing baseline design="ffma") 2.209 ms.
//
// Design: swin_wg_kernel's (two windows a block sharing every B unit a
// ring streams) in float32, with three changes that float32 forces:
// - Shared memory. A window's float32 LN buffer is 48 KB, and K and V of
//   a head with their hi and lo copies 32 KB; with O (48 KB) two windows
//   would not fit. So O never stays: each head's output O_h (64 x 32,
//   written over its K) is multiplied at once by its 32 rows of wo and
//   added into y, which lives in the consumers' registers from the first
//   head on; the MLP's hidden runs a quarter of 96 at a time, its GELU'd
//   output H_q (64 x 96) written over K and V and read back as fc2's A.
// - Registers. y (96 a thread), a 96-column sum and its partial (48 each)
//   and a K block's A fragments (32) need about 240 registers; a producer
//   warpgroup would hold every thread to 168. So the block has no
//   producer: 256 threads, two consumer warpgroups (255 registers), and
//   the warp that releases a slot last refills it (csrc/matmul_chain.cu's
//   wg_ring_chain_kernel).
// - Operand layouts. TF32 wgmma reads A and B only K-major (the transpose
//   bits are for 16-bit types), so V is written transposed (V^T: a head
//   dim a row, 64 keys along K). A float32 accumulator's n8 tile holds
//   columns 2t, 2t + 1 of rows g and g + 8, where a TF32 k8 A fragment
//   wants columns t and t + 4; so q (for S = Q K^T) and P (for O = P V)
//   are used as they come, with K within each group of 8 relabelled
//   [0, 2, 4, 6, 1, 3, 5, 7] (fragment k t holds column 2t, k t + 4 column
//   2t + 1), and the kernel writes K's head dims and V^T's keys in that
//   order: each k8 sum only changes its order.
//
// B. The wrapper packs the four matrices once a body (ops/window_attention
// .py::pack_f32_wg_units) as units of 96 rows x 128 bytes (12,288 B): 32
// TF32 values of K a row in wgmma's K-major layout with the 128-byte
// swizzle (16-byte chunk c of row n at c ^ (n % 8), 8-row groups 1024
// bytes apart), a unit the hi or the lo half of one K block of 96 output
// columns. The stream, in the order the consumers read it: per head h its
// qkv columns 96h.. (6 K blocks, hi then lo each), then proj's wo rows
// 32h.. (columns 0.., 96..); then per hidden quarter q fc1's columns 96q..
// (6 K blocks), fc2's w2 rows 96q.. (per column half 3 K blocks): 192
// units, the first 96 window_attention's. The block walks window pairs
// blockIdx.x, + gridDim.x, ...; its ring of 5 slots holds units g..g+4 of
// its pairs' run; each warp's lane 0, once the warp's wgmmas on a unit have
// completed, counts it in the slot's count, and the one that completes the
// count of 8 issues unit g + 5 into the slot (one cp.async.bulk completing
// on the slot's full mbarrier). L2 reads a launch: the units a pair
// (2,359,296 B, 1,179,648 for window_attention) and the bias table once a
// block: 4.83 GB at (1, 512, 512) (chip_smoke.py::swin_l2_bytes), half of
// a window a block.
//
// A. LN1 (read from x in global memory), LN2, O_h and H_q are written by
// the consumers into float32 buffers of 16-byte chunks, chunk c of row r
// at c ^ (r % 8) (every ldmatrix phase and every accumulator store on 8
// bank groups), and read by ldmatrix of 32-bit elements: its four 8 x 4
// matrices are wgmma's TF32 A fragment (a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4)), split into hi and lo in registers.
//
// Per window (a consumer warpgroup; warp w holds rows 16w + g, + 8):
//   LN1 -> A.
//   Per head: qkv (m64n96, 6 K blocks of 12 wgmmas, partials folded);
//     + bias; q as S's A fragments (hi, lo) in registers; k into K, v into
//     V^T (hi and lo copies, relabelled); S (m64n64, 12 wgmmas); + bias +
//     mask, softmax; P as O's A fragments; O (m64n32, 24 wgmmas); O_h
//     over K; y += O_h wo_h (two m64n96 halves, 12 wgmmas each).
//   window_attention: out = y + bo. swin_block: y = (x + y) + bo; LN2
//   from y in registers (row statistics over the quad) -> A; per quarter
//   q: fc1 (m64n96, 6 K blocks) + bias -> H_q, GELU in place; per column half,
//   fc2's partial over H_q (3 K blocks) folded into y; out = y + bf2.
// Every window sums the same units in the same order with the same
// shapes wherever it lies; an odd window count's last pair computes its
// last window again on its second consumer and drops the stores.
//
// Each K block's 12 wgmmas are waited for (wait_group 0) before its
// partial is folded; the other warpgroup's K block runs on the tensor
// cores meanwhile. The GELU runs as a loop over the thread's own values of
// H_q in shared memory, with one erff in the code: 48 inlined copies ran
// markedly slower on an H100. Tried on an H100 and not kept, none faster
// beyond the spread of the in-turns timing and some slower: y's first 64
// sums parked in the K / V^T region while qkv and fc1 run (fewer spills),
// wait_group 1 between K blocks, two K blocks a partial, O = P V in two
// halves, the next window's x staged into the A buffer by cp.async (a
// shorter LN1, not a shorter launch), GELU called instead of inlined (the
// calls spill), LN1 in batches of 4 rows, LN2 and the softmax as loops
// through shared memory like the GELU. The phase clocks
// (-DS2SR_SWIN_STAMPS, chip_smoke.py::swin_f32_phase_clocks) say where the
// time goes.
//
// Shared memory (bytes from a 1024-aligned base; ops/window_attention.py
// ::f32_wg_smem_plan):
//   ring      0        5 slots x 12,288                          61,440
//   window w  61,440 + 81,920 w (w = 0, 1):
//     A       +0       LN1, then LN2 (64 x 192 float32)          49,152
//     K hi    +49,152  K of a head (64 keys x 32), then O_h       8,192
//     K lo    +57,344                                             8,192
//     V^T hi  +65,536  V^T of a head (32 dims x 64 keys)          8,192
//     V^T lo  +73,728                                             8,192
//                      (K and V^T: the MLP's H_q, 64 x 96)
//   table     225,280  the bias table, [head][225] float32        5,400
//   barriers  230,680  a full mbarrier a slot                        40
//   counts    230,720  a release count a slot                        20
// 230,740 + up to 1,024 to align = 231,764 of the block's 232,448; a
// sixth slot would make 244,052.

constexpr int F32_THREADS = WG_WIN * 128;     // two consumer warpgroups, no producer
constexpr int F32_NBUF = 5;                   // slots of the B ring
constexpr int F32_UNIT = 96 * 128;            // a unit: 96 rows x 32 TF32
constexpr int HEAD_UNITS = 12 + 4;            // qkv's 6 K blocks, proj's 2 halves
constexpr int QUARTER_UNITS = 12 + 12;        // fc1's 6 K blocks, fc2's 2 x 3
constexpr int ATTN_UNITS = HEADS * HEAD_UNITS;               // 96
constexpr int BLOCK_UNITS = ATTN_UNITS + 4 * QUARTER_UNITS;  // 192
constexpr int LDA = CP / 4;                   // 16-byte chunks a row of A
constexpr int A_BYTES = N * CP * 4;
constexpr int HALF = 8192;                    // K or V^T of a head, hi or lo
constexpr int W_A = 0, W_KH = A_BYTES, W_KL = W_KH + HALF, W_VH = W_KL + HALF,
              W_VL = W_VH + HALF;
constexpr int F32_WIN_BYTES = W_VL + HALF;
constexpr int F32_OFF_WIN = F32_NBUF * F32_UNIT;
constexpr int F32_OFF_TABLE = F32_OFF_WIN + WG_WIN * F32_WIN_BYTES;
constexpr int F32_OFF_BAR = F32_OFF_TABLE + HEADS * TABLE * 4;
constexpr int F32_OFF_CNT = F32_OFF_BAR + 8 * F32_NBUF;
constexpr int F32_WG_SMEM = 1024 + F32_OFF_CNT + 4 * F32_NBUF;
static_assert(ATTN_UNITS == 96 && BLOCK_UNITS == 192, "the stream as noted");
static_assert(F32_OFF_WIN == 61440 && F32_WIN_BYTES == 81920 && F32_OFF_TABLE == 225280 &&
              F32_OFF_BAR == 230680 && F32_OFF_CNT == 230720 && F32_WG_SMEM == 231764,
              "shared memory as the note counts it");
static_assert(F32_WG_SMEM <= 232448, "over the 227 KB a block may opt into");
static_assert(F32_WG_SMEM + F32_UNIT > 232448, "room for another slot");
static_assert(F32_OFF_WIN % 1024 == 0 && F32_WIN_BYTES % 1024 == 0 && W_KH % 1024 == 0,
              "wgmma operands on 1024-byte swizzle atoms");
static_assert(N * 96 * 4 <= 4 * HALF, "H_q fits over K and V^T");

struct F32Args {
  const float* x;
  float* out;
  const float *g1, *b1, *bqkv, *bo, *table, *g2, *b2, *bf1, *bf2;
  const unsigned char* units;
  int H, W, shift, hshift, last_wy, windows;
};

// float32 -> TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away from
// zero): half of the 13 dropped bits' range added, then those bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
// v as TF32 hi and lo: hi = rna(v), lo = rna(v - hi) (the difference exact)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// wgmma.mma_async m64nNk8 into float32, A (TF32) from registers, B (TF32)
// by descriptor: d += A B, or with FIRST d = A B (scale-d 0), so that no
// instruction but a wgmma defines a partial sum (ptxas serialises the
// wgmmas if one does: C7515)
#define S2SR_TF32_ASM(N, D)                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #D ", 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 "
template <bool FIRST>
__device__ __forceinline__ void wg96(float* d, const uint32_t (&a)[4], uint64_t b) {
  if constexpr (FIRST)
    asm volatile(S2SR_TF32_ASM(96, 53)
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
                 "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
                 "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
                 : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
                   "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
                   "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
                   "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
                   "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
                   "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
                   "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
                   "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
                   "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
                   "=f"(d[45]), "=f"(d[46]), "=f"(d[47])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  else
    asm volatile(S2SR_TF32_ASM(96, 53)
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
                 "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
                 "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
                   "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
                   "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <bool FIRST>
__device__ __forceinline__ void wg64(float* d, const uint32_t (&a)[4], uint64_t b) {
  if constexpr (FIRST)
    asm volatile(S2SR_TF32_ASM(64, 37)
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31}, "
                 "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
                   "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
                   "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
                   "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
                   "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
                   "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
                   "=f"(d[30]), "=f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  else
    asm volatile(S2SR_TF32_ASM(64, 37)
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
                 "%24, %25, %26, %27, %28, %29, %30, %31}, "
                 "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <bool FIRST>
__device__ __forceinline__ void wg32(float* d, const uint32_t (&a)[4], uint64_t b) {
  if constexpr (FIRST)
    asm volatile(S2SR_TF32_ASM(32, 21)
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
                   "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
                   "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
                   "=f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  else
    asm volatile(S2SR_TF32_ASM(32, 21)
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
                 "%12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef S2SR_TF32_ASM

// d += p, each sum rounded to nearest
template <int NA>
__device__ __forceinline__ void fold(float* d, const float (&p)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) d[i] = __fadd_rn(d[i], p[i]);
}

__device__ __forceinline__ void stsf(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void sts2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// Byte offset of float32 (row, col) in an A buffer of LDC 16-byte chunks a
// row, chunk c of row r stored at c ^ (r % 8)
template <int LDC>
__device__ __forceinline__ uint32_t a_at(int row, int col) {
  return (uint32_t)(row * LDC * 16 + ((((col >> 2) ^ row) & 7) | ((col >> 2) & ~7)) * 16 +
                    (col & 3) * 4);
}
// Byte offset of TF32 (row, position p < 32) of a K-major 128-byte-swizzle
// operand of 128-byte rows
__device__ __forceinline__ uint32_t b_at(int row, int p) {
  return (uint32_t)(row * 128 + (((p >> 2) ^ row) & 7) * 16 + (p & 3) * 4);
}
// The place of column c of a group of 8 in a relabelled k8 step: column 2t
// at t, 2t + 1 at t + 4
__device__ __forceinline__ int relabel(int c) { return (c >> 1) + 4 * (c & 1); }

// k8 step s (columns 8s..8s+7) of the warp's 16 rows of the A buffer at
// `abuf` (LDC chunks a row) as wgmma's TF32 A fragment, split into hi, lo:
// lane l points ldmatrix.x4 at row l % 16, chunk 2s + l / 16, so that
// matrix i is a0..a3 in turn
template <int LDC>
__device__ __forceinline__ void a_frag(uint32_t (&h)[4], uint32_t (&l)[4], uint32_t abuf,
                                       int s) {
  const int lane = tidx() & 31;
  uint32_t v[4];
  ldsm(v, abuf + a_at<LDC>(16 * ((tidx() >> 5) & 3) + (lane & 15), 8 * s + 4 * (lane >> 4)));
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(v[i]), h[i], l[i]);
}

// The B ring as a warp sees it: F32_NBUF slots of a unit from 1024-aligned
// `slots`, a full mbarrier and a release count a slot; the stream of n
// units a window pair; `base` the units of the block's pairs before this
// one; `total` the units of all its pairs.
struct F32Ring {
  uint32_t slots, full, cnt;
  const unsigned char* units;
  int n, base, total;
};

// unit g of the block's run into its slot: the slot's full barrier armed
// with the unit's bytes, then one bulk copy
__device__ __forceinline__ void ring_fill(const F32Ring& r, int g) {
  const uint32_t slot = (uint32_t)(g % F32_NBUF);
  const uint32_t bar = r.full + 8 * slot;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(F32_UNIT) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               ::"r"(r.slots + slot * F32_UNIT), "l"(r.units + (size_t)(g % r.n) * F32_UNIT),
                 "r"(F32_UNIT), "r"(bar) : "memory");
}
// unit i of the current pair has landed
__device__ __forceinline__ void unit_wait(const F32Ring& r, int i) {
  const int g = r.base + i;
  mbar_wait(r.full + 8 * (g % F32_NBUF), (uint32_t)(g / F32_NBUF) & 1);
}
__device__ __forceinline__ uint32_t unit_addr(const F32Ring& r, int i) {
  return r.slots + (uint32_t)((r.base + i) % F32_NBUF) * F32_UNIT;
}
// This warp's wgmmas on unit i have completed: lane 0 counts it in its
// slot; the warp that completes the slot's count of 8 (both warpgroups'
// warps) issues the unit F32_NBUF later into it.
__device__ __forceinline__ void unit_release(const F32Ring& r, int i) {
  if ((tidx() & 31) == 0) {
    const int g = r.base + i;
    uint32_t old;
    asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                 : "=r"(old) : "r"(r.cnt + 4 * (g % F32_NBUF)) : "memory");
    if ((old & 7) == 7 && g + F32_NBUF < r.total) ring_fill(r, g + F32_NBUF);
  }
}

// part = A B from zero over KB K blocks of 32: A's K blocks kb0.. of the
// buffer at `abuf` (LDC chunks a row), B units i0 + 2b (hi) and i0 + 2b + 1
// (lo). A K block: its two units waited for, A's 4 k8 steps by ldmatrix and
// split, one fence, per k8 step lo_a hi_b, hi_a lo_b, hi_a hi_b (the
// chain's first with scale-d 0), one commit, wait_group 0, its units
// released: the other warpgroup's K block runs on the tensor cores
// meanwhile. Unrolled: no wgmma under a branch.
template <int KB, int LDC>
__device__ __forceinline__ void chain96(float (&part)[48], uint32_t abuf, int kb0,
                                        const F32Ring& r, int i0) {
#pragma unroll
  for (int b = 0; b < KB; ++b) {
    const int i = i0 + 2 * b;
    unit_wait(r, i);
    unit_wait(r, i + 1);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) a_frag<LDC>(ah[s], al[s], abuf, 4 * (kb0 + b) + s);
    const uint32_t hi = unit_addr(r, i), lo = unit_addr(r, i + 1);
    uint64_t dh[4], dl[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      dh[s] = desc_k128(hi + 32 * s);
      dl[s] = desc_k128(lo + 32 * s);
      asm volatile("" : "+l"(dh[s]), "+l"(dl[s])::"memory");
    }
    if (b > 0) fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (b == 0 && s == 0) wg96<true>(part, al[s], dh[s]);
      else wg96<false>(part, al[s], dh[s]);
      wg96<false>(part, ah[s], dl[s]);
      wg96<false>(part, ah[s], dh[s]);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
    unit_release(r, i);
    unit_release(r, i + 1);
  }
}

// acc = A B over the 6 K blocks of the 192-wide A buffer at `abuf`, units
// i0.. (hi, lo a K block), each K block's partial folded into acc
__device__ __forceinline__ void gemm96(float (&acc)[48], uint32_t abuf, const F32Ring& r,
                                       int i0) {
  zero(acc);
#pragma unroll 1
  for (int b = 0; b < CP / 32; ++b) {
    float part[48];
    chain96<1, LDA>(part, abuf, b, r, i0 + 2 * b);
    fold(acc, part);
  }
}

// LN1 of the window's x (global) into A: warp w the rows w + 4i, eight at a
// time, lane the column pairs 2 lane + 64k (columns 180..191 zero)
__device__ __forceinline__ void ln1(const F32Args& a, const WinPos& wp, uint32_t ab) {
  const int warp = (tidx() >> 5) & 3, lane = tidx() & 31;
  float2 gg[3], bb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int c = 2 * lane + 64 * k;
    gg[k] = c < C ? ld2(a.g1 + c) : make_float2(0.f, 0.f);
    bb[k] = c < C ? ld2(a.b1 + c) : make_float2(0.f, 0.f);
  }
#pragma unroll 1
  for (int i0 = 0; i0 < N / 4; i0 += 8) {
    float2 v[8][3];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float* src = a.x + token(a, wp, warp + 4 * (i0 + u));
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int c = 2 * lane + 64 * k;
        v[u][k] = c < C ? ld2(src + c) : make_float2(0.f, 0.f);
      }
    }
    float s[8], q[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] = (v[u][0].x + v[u][0].y) + (v[u][1].x + v[u][1].y) +
                                      (v[u][2].x + v[u][2].y);
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] = warp_sum(s[u]) / C;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      q[u] = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (2 * lane + 64 * k < C) {
          const float d0 = v[u][k].x - s[u], d1 = v[u][k].y - s[u];
          q[u] += d0 * d0 + d1 * d1;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = warp + 4 * (i0 + u);
      const float rstd = 1.f / sqrtf(warp_sum(q[u]) / C + EPS);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int c = 2 * lane + 64 * k;
        float o0 = 0.f, o1 = 0.f;
        if (c < C) {
          o0 = (v[u][k].x - s[u]) * rstd * gg[k].x + bb[k].x;
          o1 = (v[u][k].y - s[u]) * rstd * gg[k].y + bb[k].y;
        }
        sts2(ab + a_at<LDA>(r, c), o0, o1);
      }
    }
  }
}

// Phase clocks of swin_f32_wg_kernel, with -DS2SR_SWIN_STAMPS only (the
// copy chip_smoke.py's phase build makes): WG_STAMP at a window's phase
// boundaries into swin_wg_kernel's buffer, head 0 and hidden quarter 0
// split into their steps (every head and quarter runs the same code).
enum F32Stamp : int {
  FS_START = 0, FS_LN1 = 1, FS_QKV = 2, FS_EPI = 3, FS_S = 4, FS_SOFTMAX = 5,
  FS_PV = 6, FS_HEAD = 7, FS_ATTN = 8, FS_LN2 = 9, FS_FC1 = 10, FS_GELU = 11,
  FS_QUARTER = 12, FS_MLP = 13, FS_END = 14
};

// y (m64n192: 24 n8 tiles) + v (a vector of 192, columns < 180) into out
// at the window's tokens, rows r0 and r0 + 8 of the thread
__device__ __forceinline__ void store_out(const F32Args& a, const WinPos& wp,
                                          const float (&y)[96],
                                          const float* v) {
  const int lane = tidx() & 31, t = lane & 3;
  const int r0 = 16 * ((tidx() >> 5) & 3) + (lane >> 2);
  float* o0 = a.out + token(a, wp, r0);
  float* o1 = a.out + token(a, wp, r0 + 8);
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= C) continue;
    const float2 c = ld2(v + col);
    *reinterpret_cast<float2*>(o0 + col) = make_float2(y[4 * j] + c.x, y[4 * j + 1] + c.y);
    *reinterpret_cast<float2*>(o1 + col) = make_float2(y[4 * j + 2] + c.x, y[4 * j + 3] + c.y);
  }
}

// One consumer warpgroup: window 2 pair + wg. Thread (warp, g, t) holds
// accumulator rows r0 = 16 warp + g and r1 = r0 + 8, and of each n8 tile j
// the columns 8j + 2t, + 1: element 4j + e is row r0 (e < 2) or r1, column
// 8j + 2t + (e & 1).
template <bool MLP>
__device__ __forceinline__ void f32_window(const F32Args& a, const F32Ring& ring, uint32_t sbase,
                                           const float* tb, int pair) {
  const int wg = tidx() >> 7;
  const int warp = (tidx() >> 5) & 3, lane = tidx() & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  int win = 2 * pair + wg;
  const bool valid = win < a.windows;
  if (!valid) win = a.windows - 1;        // computed again, stores dropped
  const int shift = a.shift;
  const WinPos wp = win_pos(a, win);
  const bool lr = shift > 0 && wp.wy == a.last_wy;
  const bool lc = shift > 0 && wp.wx == a.W / WIN - 1;
  const uint32_t wb = sbase + F32_OFF_WIN + wg * F32_WIN_BYTES;
  const uint32_t ab = wb + W_A, kh = wb + W_KH, kl = wb + W_KL, vh = wb + W_VH, vl = wb + W_VL;

  WG_STAMP(pair, FS_START);
  WG_STAMP(pair, ST_T0);
  ln1(a, wp, ab);
  wg_sync(wg);
  WG_STAMP(pair, FS_LN1);

  float y[96];
  zero(y);
#pragma unroll 1
  for (int h = 0; h < HEADS; ++h) {
    const int u0 = HEAD_UNITS * h;
    uint32_t qh[4][4], ql[4][4];
    {
      float acc[48];
      gemm96(acc, ab, ring, u0);
      if (h == 0) WG_STAMP(pair, FS_QKV);
      // + bias: q as S's A fragments (k8 step s: q's columns 8s + 2t at
      // a0 / a1, 8s + 2t + 1 at a2 / a3); k into K at key r, places
      // relabelled; v into V^T at dim d, its keys' places relabelled
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const float2 c = ld2(a.bqkv + 96 * h + 8 * j + 2 * t);
        const float v00 = acc[4 * j] + c.x, v01 = acc[4 * j + 1] + c.y;
        const float v10 = acc[4 * j + 2] + c.x, v11 = acc[4 * j + 3] + c.y;
        uint32_t s00, s01, s10, s11, z00, z01, z10, z11;
        split(v00, s00, z00);
        split(v01, s01, z01);
        split(v10, s10, z10);
        split(v11, s11, z11);
        if (j < 4) {
          qh[j][0] = s00, ql[j][0] = z00;
          qh[j][1] = s10, ql[j][1] = z10;
          qh[j][2] = s01, ql[j][2] = z01;
          qh[j][3] = s11, ql[j][3] = z11;
        } else if (j < 8) {
          const int p = 8 * (j - 4) + t;
          stsf(kh + b_at(r0, p), __uint_as_float(s00));
          stsf(kl + b_at(r0, p), __uint_as_float(z00));
          stsf(kh + b_at(r0, p + 4), __uint_as_float(s01));
          stsf(kl + b_at(r0, p + 4), __uint_as_float(z01));
          stsf(kh + b_at(r1, p), __uint_as_float(s10));
          stsf(kl + b_at(r1, p), __uint_as_float(z10));
          stsf(kh + b_at(r1, p + 4), __uint_as_float(s11));
          stsf(kl + b_at(r1, p + 4), __uint_as_float(z11));
        } else {
          const int d = 8 * (j - 8) + 2 * t;
          const int p = 16 * warp + relabel(g);        // key r0's place; r1's + 8
          const uint32_t o = (uint32_t)(p >> 5) * 4096;
          stsf(vh + o + b_at(d, p & 31), __uint_as_float(s00));
          stsf(vl + o + b_at(d, p & 31), __uint_as_float(z00));
          stsf(vh + o + b_at(d + 1, p & 31), __uint_as_float(s01));
          stsf(vl + o + b_at(d + 1, p & 31), __uint_as_float(z01));
          stsf(vh + o + b_at(d, (p + 8) & 31), __uint_as_float(s10));
          stsf(vl + o + b_at(d, (p + 8) & 31), __uint_as_float(z10));
          stsf(vh + o + b_at(d + 1, (p + 8) & 31), __uint_as_float(s11));
          stsf(vl + o + b_at(d + 1, (p + 8) & 31), __uint_as_float(z11));
        }
      }
    }
    fence_async();
    wg_sync(wg);
    if (h == 0) WG_STAMP(pair, FS_EPI);
    // S = q K^T: key tile n holds keys 8n + 2t (+1) of rows r0, r1
    float sc[32];
    {
      uint64_t dh[4], dl[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        dh[s] = desc_k128(kh + 32 * s);
        dl[s] = desc_k128(kl + 32 * s);
        asm volatile("" : "+l"(dh[s]), "+l"(dl[s])::"memory");
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s == 0) wg64<true>(sc, ql[s], dh[s]);
        else wg64<false>(sc, ql[s], dh[s]);
        wg64<false>(sc, qh[s], dl[s]);
        wg64<false>(sc, qh[s], dh[s]);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
    }
    if (h == 0) WG_STAMP(pair, FS_S);
    // + bias + mask (row i = 8 yi + xi: yi = 2 warp + e / 2, xi = g; key
    // j = 8n + 2t + e % 2: yj = n, xj = 2t + e % 2), then the softmax
    {
      const float* bias = tb + h * TABLE;
      const int edge = WIN - shift;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int yi = 2 * warp + (e >> 1), xi = g, yj = n, xj = 2 * t + (e & 1);
          float v = sc[4 * n + e] +
                    bias[(yi - yj + WIN - 1) * (2 * WIN - 1) + xi - xj + WIN - 1];
          if (shift > 0) {
            const bool apart = (lr && ((yi >= edge) != (yj >= edge))) ||
                               (lc && ((xi >= edge) != (xj >= edge)));
            v += apart ? -100.f : 0.f;
          }
          sc[4 * n + e] = v;
          if (e < 2) mx0 = fmaxf(mx0, v);
          else mx1 = fmaxf(mx1, v);
        }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        sc[4 * n] = expf(sc[4 * n] - mx0);
        sc[4 * n + 1] = expf(sc[4 * n + 1] - mx0);
        sc[4 * n + 2] = expf(sc[4 * n + 2] - mx1);
        sc[4 * n + 3] = expf(sc[4 * n + 3] - mx1);
        sum0 += sc[4 * n] + sc[4 * n + 1];
        sum1 += sc[4 * n + 2] + sc[4 * n + 3];
      }
      const float inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        sc[4 * n] *= inv0;
        sc[4 * n + 1] *= inv0;
        sc[4 * n + 2] *= inv1;
        sc[4 * n + 3] *= inv1;
      }
    }
    if (h == 0) WG_STAMP(pair, FS_SOFTMAX);
    // O = P V: P's key tile n is k8 step n (keys 8n + 2t at a0 / a1, 8n + 2t
    // + 1 at a2 / a3), V^T's keys relabelled to match; in two halves of 4
    // k8 steps (keys 0..31, 32..63: V^T's two K blocks), each waited for
    // before the next, so that a half's A fragments and descriptors alone
    // are live beside y
    float oa[16];
    {
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        split(sc[4 * n], ph[n][0], pl[n][0]);
        split(sc[4 * n + 2], ph[n][1], pl[n][1]);
        split(sc[4 * n + 1], ph[n][2], pl[n][2]);
        split(sc[4 * n + 3], ph[n][3], pl[n][3]);
      }
      uint64_t dh[8], dl[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t o = (uint32_t)(n >> 2) * 4096 + 32 * (n & 3);
        dh[n] = desc_k128(vh + o);
        dl[n] = desc_k128(vl + o);
        asm volatile("" : "+l"(dh[n]), "+l"(dl[n])::"memory");
      }
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n == 0) wg32<true>(oa, pl[n], dh[n]);
        else wg32<false>(oa, pl[n], dh[n]);
        wg32<false>(oa, ph[n], dl[n]);
        wg32<false>(oa, ph[n], dh[n]);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(oa);
    }
    if (h == 0) WG_STAMP(pair, FS_PV);
    // O_h over K hi (64 x 32, 8 chunks a row), then y += O_h wo_h a column
    // half at a time
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int col = 8 * d + 2 * t;
      sts2(kh + a_at<8>(r0, col), oa[4 * d], oa[4 * d + 1]);
      sts2(kh + a_at<8>(r1, col), oa[4 * d + 2], oa[4 * d + 3]);
    }
    wg_sync(wg);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float part[48];
      chain96<1, 8>(part, kh, 0, ring, u0 + 12 + 2 * u);
      fold(y + 48 * u, part);
    }
    // O_h read by every warp before the next head's K overwrites it
    wg_sync(wg);
    if (h == 0) WG_STAMP(pair, FS_HEAD);
  }
  WG_STAMP(pair, FS_ATTN);

  if constexpr (!MLP) {
    if (valid) store_out(a, wp, y, a.bo);
    WG_STAMP(pair, FS_END);
    WG_STAMP(pair, ST_T1);
    return;
  }
  // y = (x + proj) + bo over the 180 columns (the pads 0); LN2 from the
  // registers: row statistics over the quad
  {
    const float* x0 = a.x + token(a, wp, r0);
    const float* x1 = a.x + token(a, wp, r1);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < C) {
        const float2 c = ld2(a.bo + col), xa = ld2(x0 + col), xb = ld2(x1 + col);
        y[4 * j] = (xa.x + y[4 * j]) + c.x;
        y[4 * j + 1] = (xa.y + y[4 * j + 1]) + c.y;
        y[4 * j + 2] = (xb.x + y[4 * j + 2]) + c.x;
        y[4 * j + 3] = (xb.y + y[4 * j + 3]) + c.y;
        s0 += y[4 * j] + y[4 * j + 1];
        s1 += y[4 * j + 2] + y[4 * j + 3];
      } else {
        y[4 * j] = y[4 * j + 1] = y[4 * j + 2] = y[4 * j + 3] = 0.f;
      }
    }
    const float mean0 = quad_sum(s0) / C, mean1 = quad_sum(s1) / C;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      if (8 * j + 2 * t < C) {
        const float d0 = y[4 * j] - mean0, d1 = y[4 * j + 1] - mean0;
        const float d2 = y[4 * j + 2] - mean1, d3 = y[4 * j + 3] - mean1;
        q0 += d0 * d0 + d1 * d1;
        q1 += d2 * d2 + d3 * d3;
      }
    }
    const float rstd0 = 1.f / sqrtf(quad_sum(q0) / C + EPS);
    const float rstd1 = 1.f / sqrtf(quad_sum(q1) / C + EPS);
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = 8 * j + 2 * t;
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
      if (col < C) {
        const float2 gv = ld2(a.g2 + col), bv = ld2(a.b2 + col);
        o0 = (y[4 * j] - mean0) * rstd0 * gv.x + bv.x;
        o1 = (y[4 * j + 1] - mean0) * rstd0 * gv.y + bv.y;
        o2 = (y[4 * j + 2] - mean1) * rstd1 * gv.x + bv.x;
        o3 = (y[4 * j + 3] - mean1) * rstd1 * gv.y + bv.y;
      }
      sts2(ab + a_at<LDA>(r0, col), o0, o1);
      sts2(ab + a_at<LDA>(r1, col), o2, o3);
    }
  }
  wg_sync(wg);
  WG_STAMP(pair, FS_LN2);
  // the MLP a quarter of the hidden at a time: fc1's 96 columns 96q.. + bias,
  // GELU, into H_q over K and V^T (24 chunks a row); y += H_q w2's rows
  // 96q.. a column half at a time
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const int u0 = ATTN_UNITS + QUARTER_UNITS * q;
    {
      float f[48];
      gemm96(f, ab, ring, u0);
      if (q == 0) WG_STAMP(pair, FS_FC1);
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 c = ld2(a.bf1 + 96 * q + col);
        sts2(kh + a_at<24>(r0, col), f[4 * j] + c.x, f[4 * j + 1] + c.y);
        sts2(kh + a_at<24>(r1, col), f[4 * j + 2] + c.x, f[4 * j + 3] + c.y);
      }
      // GELU over the thread's own 48 values in place, in a loop: one erff
      // in the code (48 inlined copies ran slower on an H100, likely for
      // the size of the code a quarter runs)
#pragma unroll 1
      for (int k = 0; k < 24; ++k) {
        const uint32_t at = kh + a_at<24>(k & 1 ? r1 : r0, 8 * (k >> 1) + 2 * t);
        float2 v = lds2(at);
        v.x = 0.5f * v.x * (1.f + erff(v.x * 0.70710678118654752f));
        v.y = 0.5f * v.y * (1.f + erff(v.y * 0.70710678118654752f));
        sts2(at, v.x, v.y);
      }
    }
    wg_sync(wg);
    if (q == 0) WG_STAMP(pair, FS_GELU);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float part[48];
      chain96<3, 24>(part, kh, 0, ring, u0 + 12 + 6 * u);
      fold(y + 48 * u, part);
    }
    // H_q read by every warp before the next quarter's overwrites it
    wg_sync(wg);
    if (q == 0) WG_STAMP(pair, FS_QUARTER);
  }
  WG_STAMP(pair, FS_MLP);
  if (valid) store_out(a, wp, y, a.bf2);
  WG_STAMP(pair, FS_END);
  WG_STAMP(pair, ST_T1);
}

// The body: the ring's barriers and counts, the bias table, the first F32_NBUF
// units, then the window pairs blockIdx.x, + gridDim.x, ...
template <bool MLP>
__global__ void __launch_bounds__(F32_THREADS, 1) swin_f32_wg_kernel(const F32Args a) {
  extern __shared__ __align__(128) unsigned char f32_smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(f32_smem);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  unsigned char* base = f32_smem + (sbase - raw);
  const int pairs = (a.windows + 1) / 2;
  F32Ring ring;
  ring.slots = sbase;
  ring.full = sbase + F32_OFF_BAR;
  ring.cnt = sbase + F32_OFF_CNT;
  ring.units = a.units;
  ring.n = MLP ? BLOCK_UNITS : ATTN_UNITS;
  ring.base = 0;
  ring.total = ring.n * ((pairs - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x);
  float* tb = reinterpret_cast<float*>(base + F32_OFF_TABLE);
  if (threadIdx.x == 0) {
    for (int i = 0; i < F32_NBUF; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(ring.full + 8 * i) : "memory");
      asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(ring.cnt + 4 * i) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the bias table, [head][225]
  for (int i = threadIdx.x; i < HEADS * TABLE; i += F32_THREADS)
    tb[i] = __ldg(a.table + (i % TABLE) * HEADS + i / TABLE);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < F32_NBUF && g < ring.total; ++g) ring_fill(ring, g);
#pragma unroll 1
  for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
    f32_window<MLP>(a, ring, sbase, tb, p);
    ring.base += ring.n;
  }
}

// swin_f32_wg_kernel<mlp>, its shared memory set on it; set on every call,
// so that it holds on whichever device is current
int prepare_f32(int mlp, const void** fn) {
  const void* k = mlp ? (const void*)swin_f32_wg_kernel<true>
                      : (const void*)swin_f32_wg_kernel<false>;
  *fn = k;
  return (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   F32_WG_SMEM);
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

// swin_wg_kernel<mlp> (variant 0) or swin_wg_no_l2_kernel (variant 1, mlp
// only), its shared memory set on it; set on every call, so that it holds
// on whichever device is current.
int prepare_wg(int mlp, int variant, const void** fn) {
  const void* k = variant == WG_NO_L2 ? (const void*)swin_wg_no_l2_kernel
                  : mlp              ? (const void*)swin_wg_kernel<true>
                                     : (const void*)swin_wg_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       WG_SMEM);
  *fn = k;
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
// bfloat16 kernel, swin_tc_kernel (the other four may be null there, and
// these for float32). mlp: 1 = whole Swin block, 0 = attention only.
// Both dtypes here are designs which nothing served launches: bfloat16 the
// mma.sync design, swin_mma, float32 the CUDA-core design, design="ffma";
// served bf16 goes to s2sr_swin_wg_forward, served float32 to
// s2sr_swin_f32_wg_forward. Returns the CUDA error code
// of the launch (0 = success).
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

// The served bf16 kernel, swin_wg_kernel: x, out (B, H, W, 180) bf16
// contiguous, H and W multiples of 8, 16-byte aligned; g1, b1, g2, b2 (180),
// bqkv (576), bo (192), bf1 (384), bf2 (192) float32; table the (225, 6)
// float32 relative-position bias table; slabs the bf16 B slabs of wqkv, wo,
// w1, w2 (ops/window_attention.py::pack_wg_slabs). mlp: 1 = whole Swin
// block, 0 = attention only; band as s2sr_swin_forward's; variant 0 the
// served kernel, 1 swin_wg_no_l2_kernel (mlp 1 only; never served).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int s2sr_swin_wg_forward(
    const void* x, void* out, const void* g1, const void* b1, const void* bqkv,
    const void* bo, const void* table, const void* g2, const void* b2,
    const void* bf1, const void* bf2, const void* slabs, int B, int H, int W,
    int shift, int mlp, int band, int variant, void* stream) {
  if (band < 0 || band > 2 || variant < 0 || variant > 1 || (variant && !mlp) ||
      !slabs || !table)
    return (int)cudaErrorInvalidValue;
  long long windows;
  int rc = check_grid(B, H, W, shift, &windows);
  if (rc) return rc;
  const void* fn;
  rc = prepare_wg(mlp, variant, &fn);
  if (rc) return rc;
  SwinArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bo = static_cast<const float*>(bo);
  a.table = static_cast<const float*>(table);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.bf1 = static_cast<const float*>(bf1);
  a.bf2 = static_cast<const float*>(bf2);
  a.slabs = static_cast<const unsigned char*>(slabs);
  a.H = H;
  a.W = W;
  a.shift = shift;
  a.hshift = band ? 0 : shift;
  a.last_wy = band == 1 ? -1 : H / WIN - 1;
  a.windows = (int)windows;
  // one block an SM, each walking window pairs
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long pairs = (windows + WG_WIN - 1) / WG_WIN;
  const unsigned grid = (unsigned)(pairs < sms ? pairs : sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == WG_NO_L2)
    swin_wg_no_l2_kernel<<<grid, WG_THREADS, WG_SMEM, st>>>(a);
  else if (mlp)
    swin_wg_kernel<true><<<grid, WG_THREADS, WG_SMEM, st>>>(a);
  else
    swin_wg_kernel<false><<<grid, WG_THREADS, WG_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" long long s2sr_swin_wg_smem_bytes() { return (long long)WG_SMEM; }

// The phase clocks of the last launch, [pair][consumer][WgStamp] int64, into
// host memory dst (STAMP_PAIRS x 2 x STAMPS): 0 on success; -1 where the
// library was built without -DS2SR_SWIN_STAMPS.
extern "C" int s2sr_swin_wg_stamps(void* dst, int* pairs, int* stamps) {
#ifdef S2SR_SWIN_STAMPS
  *pairs = STAMP_PAIRS;
  *stamps = STAMPS;
  return dst ? (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)) : 0;
#else
  *pairs = 0;
  *stamps = STAMPS;
  return -1;
#endif
}

// Resident blocks per SM of swin_wg_kernel<mlp> on the current device;
// negative: minus the CUDA error code.
extern "C" int s2sr_swin_wg_blocks_per_sm(int mlp) {
  const void* fn;
  int n = 0;
  int rc = prepare_wg(mlp, WG_SERVED, &fn);
  if (!rc)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, WG_THREADS, WG_SMEM);
  return rc ? -rc : n;
}

// Dynamic shared-memory bytes per block of s2sr_swin_forward's kernels, by
// dtype (both modes).
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

// The served float32 kernel, swin_f32_wg_kernel: x, out (B, H, W, 180)
// float32 contiguous, H and W multiples of 8, 16-byte aligned; g1, b1, g2,
// b2 (180), bqkv (576), bo (192), bf1 (384), bf2 (192) float32; table the
// (225, 6) float32 relative-position bias table; units the hi and lo TF32
// units of wqkv, wo, w1, w2 (ops/window_attention.py::pack_f32_wg_units).
// mlp: 1 = whole Swin block, 0 = attention only; band 0: the whole image,
// rolled here in H and W; 1, 2: a band of H already rolled in H by -shift
// (only W is rolled here), 2 the one that holds the image's last window
// row. Returns the CUDA error code of the launch (0 = success).
extern "C" int s2sr_swin_f32_wg_forward(
    const void* x, void* out, const void* g1, const void* b1, const void* bqkv,
    const void* bo, const void* table, const void* g2, const void* b2,
    const void* bf1, const void* bf2, const void* units, int B, int H, int W,
    int shift, int mlp, int band, void* stream) {
  if (band < 0 || band > 2 || !units || !table) return (int)cudaErrorInvalidValue;
  long long windows;
  int rc = check_grid(B, H, W, shift, &windows);
  if (rc) return rc;
  const void* fn;
  rc = prepare_f32(mlp, &fn);
  if (rc) return rc;
  F32Args a;
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bo = static_cast<const float*>(bo);
  a.table = static_cast<const float*>(table);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.bf1 = static_cast<const float*>(bf1);
  a.bf2 = static_cast<const float*>(bf2);
  a.units = static_cast<const unsigned char*>(units);
  a.H = H;
  a.W = W;
  a.shift = shift;
  a.hshift = band ? 0 : shift;
  a.last_wy = band == 1 ? -1 : H / WIN - 1;
  a.windows = (int)windows;
  // one block an SM, each walking window pairs
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long pairs = (windows + 1) / 2;
  const unsigned grid = (unsigned)(pairs < sms ? pairs : sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mlp)
    swin_f32_wg_kernel<true><<<grid, F32_THREADS, F32_WG_SMEM, st>>>(a);
  else
    swin_f32_wg_kernel<false><<<grid, F32_THREADS, F32_WG_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" long long s2sr_swin_f32_wg_smem_bytes() { return (long long)F32_WG_SMEM; }

// Resident blocks per SM of swin_f32_wg_kernel<mlp> on the current device;
// negative: minus the CUDA error code.
extern "C" int s2sr_swin_f32_wg_blocks_per_sm(int mlp) {
  const void* fn;
  int n = 0;
  int rc = prepare_f32(mlp, &fn);
  if (!rc)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, F32_THREADS, F32_WG_SMEM);
  return rc ? -rc : n;
}

// Multiply-adds swin_f32_wg_kernel<mlp> executes per window, each of its
// three TF32 products (pads included: head dim 32, C 192, hidden 384): qkv
// 64 x 192 x 576, S and PV 6 x 64 x 64 x 32 each, proj 64 x 192 x 192, fc1
// 64 x 192 x 384, fc2 64 x 384 x 192.
extern "C" long long s2sr_swin_f32_wg_macs_per_window(int mlp) {
  const long long attn = (long long)N * CP * 576 + 2LL * HEADS * N * N * 32 +
                         (long long)N * CP * CP;
  return attn + (mlp ? 2LL * N * CP * 384 : 0);
}

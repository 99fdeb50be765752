// RDB ablation ladder: the fused-RDB rungs v1, v2 and v3, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels s2sr_tpu/ops/pallas/fused_rdb.py::rdb_pallas
// (rung v1), ::rdb_pallas_v2 (rung v2) and ::rdb_pallas_v3 (rung v3). Each
// computes, in one launch per block of the network, the function of
// s2sr_tpu/models/rrdbnet.py::_rdb_packed: five 3x3 zero-padded SAME convs
// over the dense concat, LeakyReLU slope 0.2, x_k zero outside the image,
// out = 0.2 * (x5 + b5) + x. Storage is float32 or bfloat16; products,
// bias, LeakyReLU and the tail run in float32. The rungs differ in how the
// convs are formulated as matrix products, and round where their TPU
// kernels round.
//
// v2 and v3, the delta form: the conv of each source (x, then x1..x4)
// emits its contributions to every later stage at once, into accumulator
// slots c1..c5 held in the storage dtype:
//
//   [c5|c4|c3|c2|c1]  = conv(x, wx)                          N = 192
//   x1 = lrelu(c1 + b1);   [c5|c4|c3|c2] += conv(x1, w1)     N = 160
//   x2 = lrelu(c2 + b2);   [c5|c4|c3]    += conv(x2, w2)     N = 128
//   x3 = lrelu(c3 + b3);   [c5|c4]       += conv(x3, w3)     N = 96
//   x4 = lrelu(c4 + b4);   x5 = c5       +  conv(x4, w4)     N = 64
//
// Each product's output and each slot add round to the storage dtype. v2
// stages the three dx taps of one dy at a time (three products per conv,
// TAPS = 3), v3 all nine taps (one product, TAPS = 9).
//
// v1, the K-packed concat form: the conv of x emits [p1|p2|p3|p4|p5]
// (N = 192; p1..p4 rounded to the storage dtype, p5 kept in float32), then
// each stage k = 2..5 convolves the growth buffer, x1..x4 stacked in 128
// lanes, against weights whose rows for x_k..x4 are zero (the TPU kernel's
// full-width contraction; the zero rows are executed, as there):
//
//   x1 = lrelu(p1 + b1);   x_k = lrelu(p_k + conv(g, wg_k) + b_k)   k = 2..4
//   x5 = p5 + conv(g, wg5)
//
// Every product runs in output chunks of 64 columns, as in the TPU kernel.
// x is carried at 64 lanes: the TPU kernel's 64 zero lanes of x (a DMA
// alignment pad) and their zero weight rows are skipped.
//
// What bounds them: operations (479,232 useful FLOP per pixel against 256
// bytes moved per pixel in bf16). Like csrc/rdb.cu, this first version
// does the arithmetic in float32 FMA on the CUDA cores (67 TFLOP/s peak),
// not on the tensor cores; product() below is the one place where
// mma.sync / wgmma would go.
//
// The shared idea: a conv is a matrix product of a staged operand A
// (pixels, taps x Cin) with the packed weights B, accumulated in registers.
// Each thread block owns one TILE x TILE output tile of one image. The
// stage-k values (slot c_k, or p_k, then x_k in place) live in shared
// memory over the region R_k where x_k is needed, of side TILE + 2*(5-k),
// planar [channel][y][x]; v1's p5 (float32) and the delta form's c5 over
// the tile itself. The x window is not held: source x is staged straight
// from device memory (L2), and the residual re-read there. A chunk of
// CHUNK pixels is staged into shared memory as [k][pixel]; the weights
// stream from L2 through L1. A warp tile is 32 pixels x 32 columns, a lane
// 4 pixels x 8 columns (32 accumulators, one shared and two 16-byte global
// loads per 32 FMAs).
//
// In the delta form, source j walks the pixels of R_{j+1} innermost region
// first, then ring by ring outwards: a pixel of the inner tile feeds every
// later slot (all N columns), one of the outermost ring only c_{j+1}
// (32 columns), so each chunk computes the columns its innermost pixel
// needs and the wide products stay wide where they are needed. v1 walks
// each region in raster order and computes every column everywhere, as
// its TPU kernel does over its whole window.
//
// Tiles (the largest whose values and staging fit the 232,448 bytes a
// block may use): bf16 v1 13x13, v2 19x19, v3 16x16; fp32 v1 9x9, v2
// 11x11, v3 10x10.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NF = 64;            // features
constexpr int G = 32;             // growth channels
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr long long SMEM_LIMIT = 232448;
constexpr int PIX = 4;            // pixels of a lane in a warp tile
constexpr int COLS = 8;           // columns of a lane in a warp tile
constexpr int WT = 32;            // warp tile: 32 pixels x 32 columns
constexpr int LANES = 4 * G;      // v1's growth buffer: x1..x4 stacked
constexpr int V1_COLS = 64;       // v1's output chunk

// source j: 0 = x, 1..4 = x_j
__host__ __device__ constexpr int src_cin(int j) { return j == 0 ? NF : G; }
// columns of source j's delta-form product, [c5 (64) | c4 | ... | c_{j+1}]
__host__ __device__ constexpr int src_n(int j) { return NF + G * (4 - j); }
// side of region R_k (k = 1..5), where stage k's values live
__host__ __device__ constexpr int side(int tile, int k) {
  return tile + 2 * (5 - k);
}
__host__ __device__ constexpr int slot_chans(int k) { return k < 5 ? G : NF; }
// element offset of slot k (k = 1..5); slot_off(tile, 6) is the total.
// v1 keeps slots 1..4 (p_k, then x_k) and its float32 p5 after them.
__host__ __device__ constexpr int slot_off(int tile, int k) {
  int off = 0;
  for (int i = 1; i < k; ++i) off += slot_chans(i) * side(tile, i) * side(tile, i);
  return off;
}
// shared-memory bytes before the staging buffer
constexpr long long values_bytes(bool v1, int tile, int elem) {
  return v1 ? (long long)slot_off(tile, 5) * elem + 4LL * NF * tile * tile
            : (long long)slot_off(tile, 6) * elem;
}
constexpr int pick_tile(bool v1, int elem, long long stage_bytes) {
  int t = 32;
  while (t > 1 && values_bytes(v1, t, elem) + stage_bytes > SMEM_LIMIT) --t;
  return t;
}
constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Pixel i of region R_{j+1} (side tile + 2*nr) in the delta form's order:
// the inner tile R5 in raster order, then each ring outwards (top row,
// bottom row, left column, right column). Coordinates are relative to
// R_{j+1}.
__device__ __forceinline__ void ring_coords(int i, int tile, int nr, int& qy,
                                            int& qx) {
  if (i < tile * tile) {
    qy = nr + i / tile;
    qx = nr + i % tile;
    return;
  }
  i -= tile * tile;
  for (int m = 1; m <= nr; ++m) {
    const int s = tile + 2 * m;          // outer side of ring m
    const int o = nr - m;                // its top-left corner in R_{j+1}
    if (i < 4 * (s - 1)) {
      if (i < s) {
        qy = o; qx = o + i;
      } else if (i < 2 * s) {
        qy = o + s - 1; qx = o + i - s;
      } else if (i < 3 * s - 2) {
        qy = o + 1 + i - 2 * s; qx = o;
      } else {
        qy = o + 1 + i - (3 * s - 2); qx = o + s - 1;
      }
      return;
    }
    i -= 4 * (s - 1);
  }
  qy = qx = 0;                           // not reached for i < side^2
}

// First column pixel i needs: 0 in the inner tile (every slot), else the
// column of c_{5-m} for ring m (slots c_{j+1}..c_{5-m}).
__host__ __device__ constexpr int first_col(int i, int tile, int nr) {
  if (i < tile * tile) return 0;
  i -= tile * tile;
  for (int m = 1; m <= nr; ++m) {
    if (i < 4 * (tile + 2 * m - 1)) return NF + G * (m - 1);
    i -= 4 * (tile + 2 * m - 1);
  }
  return 0;
}

// Tiling of the delta-form rungs (TAPS = 3: v2, 9: v3).
template <typename T, int TAPS>
struct Cfg {
  static constexpr int CHUNK = (sizeof(T) == 4 && TAPS == 9) ? 32 : 64;
  static constexpr long long STAGE_BYTES =
      (long long)TAPS * NF * CHUNK * (long long)sizeof(T);
  static constexpr int TILE = pick_tile(false, (int)sizeof(T), STAGE_BYTES);
  static constexpr long long SMEM =
      values_bytes(false, TILE, (int)sizeof(T)) + STAGE_BYTES;
  static constexpr int PT = CHUNK / WT;                 // pixel tiles per chunk
  static constexpr int MAXT = cdiv(PT * (src_n(0) / WT), NWARPS);
  static_assert(SMEM <= SMEM_LIMIT, "shared memory over the block limit");

  // Multiply-adds one block executes for its tile, halo recompute and the
  // last chunk's padding included: run_source's chunks, each over the
  // PT * (N - start) / WT warp tiles its loop launches.
  static constexpr long long macs() {
    long long m = 0;
    for (int j = 0; j < 5; ++j) {
      const int s = side(TILE, j + 1);
      for (int i0 = 0; i0 < s * s; i0 += CHUNK)
        m += (long long)PT * ((src_n(j) - first_col(i0, TILE, 4 - j)) / WT) *
             WT * WT * 9 * src_cin(j);
    }
    return m;
  }
};

// Tiling of rung v1.
template <typename T>
struct V1Cfg {
  static constexpr int CHUNK = sizeof(T) == 2 ? 128 : 64;
  static constexpr long long STAGE_BYTES =
      3LL * LANES * CHUNK * (long long)sizeof(T);
  static constexpr int TILE = pick_tile(true, (int)sizeof(T), STAGE_BYTES);
  static constexpr long long SMEM =
      values_bytes(true, TILE, (int)sizeof(T)) + STAGE_BYTES;
  static constexpr int PT = CHUNK / WT;
  static constexpr int MAXT = cdiv(PT * (V1_COLS / WT), NWARPS);
  static_assert(SMEM <= SMEM_LIMIT, "shared memory over the block limit");

  // v1_stage1: each chunk of R_1 over all 192 columns and 9 * 64 taps;
  // v1_stage<K>: each chunk of R_K over 32 (64 for K = 5) columns and
  // 9 * 128 lanes, zero rows included.
  static constexpr long long macs() {
    long long m = 0;
    for (int k = 1; k <= 5; ++k) {
      const long long px = (long long)cdiv(side(TILE, k) * side(TILE, k), CHUNK) * CHUNK;
      m += k == 1 ? px * src_n(0) * 9 * NF : px * slot_chans(k) * 9 * LANES;
    }
    return m;
  }
};

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
// v rounded to the storage dtype, back in float32
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}
__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : __fmul_rn(v, 0.2f);
}

// four consecutive staged values from shared memory, as float32
__device__ __forceinline__ void load4(const float* p, float (&a)[PIX]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&a)[PIX]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  a[0] = __uint_as_float(v.x << 16);
  a[1] = __uint_as_float(v.x & 0xffff0000u);
  a[2] = __uint_as_float(v.y << 16);
  a[3] = __uint_as_float(v.y & 0xffff0000u);
}

// eight consecutive channels of one pixel from device memory
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, T (&v)[8]) {
  constexpr int NV = (int)sizeof(T) / 2;               // uint4s for 8 values
  uint4 w[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  memcpy(v, w, sizeof(v));
}

// The product of one staged chunk: acc += A[:, p0:p0+4]^T B[:, c0:c0+8]
// over K rows. A is [K][CHUNK] in shared memory (storage dtype), B the
// packed weights [K][ldb] (float32, device memory).
template <typename T, int CHUNK>
__device__ __forceinline__ void product(const T* __restrict__ A, int K,
                                        const float* __restrict__ B, int ldb,
                                        int p0, int c0,
                                        float (&acc)[PIX][COLS]) {
  const float* bp = B + c0;
  const T* ap = A + p0;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[PIX];
    load4(ap + k * CHUNK, a);
    const float4* q = reinterpret_cast<const float4*>(bp + (size_t)k * ldb);
    const float4 b0 = __ldg(q), b1 = __ldg(q + 1);
    const float b[COLS] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < PIX; ++i)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

template <int MAXT>
__device__ __forceinline__ void zero(float (&acc)[MAXT][PIX][COLS]) {
#pragma unroll
  for (int ti = 0; ti < MAXT; ++ti)
#pragma unroll
    for (int i = 0; i < PIX; ++i)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[ti][i][c] = 0.f;
}

struct Weights {
  const float* w[5];     // the rung's five packed matrices
  const float* b14;      // 128
  const float* b5;       // 64
};

// Stage taps [pass*TAPS, (pass+1)*TAPS) of source x into A[tap*NF + c][p]
// for this thread's pixel p, whose 3x3 window starts at image row gy0,
// column gx0; zero outside the image.
template <typename T, int TAPS, int CHUNK>
__device__ __forceinline__ void stage_x(T* __restrict__ A,
                                        const T* __restrict__ x, int pass,
                                        bool valid, int gy0, int gx0, int b,
                                        int H, int W) {
  constexpr int KSTEP = THREADS / CHUNK;
  const int p = threadIdx.x % CHUNK;
  const int kg = threadIdx.x / CHUNK;
#pragma unroll
  for (int tp = 0; tp < TAPS; ++tp) {
    const int tap = pass * TAPS + tp;
    const int gy = gy0 + tap / 3, gx = gx0 + tap % 3;
    const bool in = valid && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const T* px = x + (((size_t)b * H + (in ? gy : 0)) * W + (in ? gx : 0)) * NF;
#pragma unroll
    for (int c8 = kg; c8 < NF / 8; c8 += KSTEP) {
      T v[8];
      if (in) {
        load8(px + c8 * 8, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = from_f<T>(0.f);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) A[(tp * NF + c8 * 8 + e) * CHUNK + p] = v[e];
    }
  }
}

// x_K = lrelu(c + b) in place of slot K's values over R_K, zero outside
// the image.
template <typename T, int TILE, int K>
__device__ __forceinline__ void activate(T* smem, const float* __restrict__ b14,
                                         int H, int W, int oy0, int ox0) {
  constexpr int S = side(TILE, K);
  constexpr int NPIX = S * S;
  T* c = smem + slot_off(TILE, K);
  const float* bias = b14 + (K - 1) * G;
  for (int e = threadIdx.x; e < G * NPIX; e += THREADS) {
    const int pp = e % NPIX;
    const int gy = oy0 - (5 - K) + pp / S;
    const int gx = ox0 - (5 - K) + pp % S;
    const float v = lrelu(__fadd_rn(to_f(c[e]), bias[e / NPIX]));
    c[e] = from_f<T>(gy >= 0 && gy < H && gx >= 0 && gx < W ? v : 0.f);
  }
}

// --- v2 / v3: the delta form -------------------------------------------------

// Stage rows [pass*TAPS*Cin, (pass+1)*TAPS*Cin) of the chunk of source J
// starting at pixel i0 into A[k][pixel].
template <typename T, int TAPS, int TILE, int CHUNK, int J>
__device__ __forceinline__ void stage(T* __restrict__ A, const T* smem,
                                      const T* __restrict__ x, int pass,
                                      int i0, int b, int H, int W, int oy0,
                                      int ox0) {
  constexpr int NR = 4 - J;
  constexpr int S = TILE + 2 * NR;
  const int p = threadIdx.x % CHUNK;
  const bool valid = i0 + p < S * S;
  int qy = 0, qx = 0;
  if (valid) ring_coords(i0 + p, TILE, NR, qy, qx);
  if constexpr (J == 0) {
    stage_x<T, TAPS, CHUNK>(A, x, pass, valid, oy0 - NR + qy - 1,
                            ox0 - NR + qx - 1, b, H, W);
  } else {
    // source x_J from its slot over R_J (side S + 2); pixel (qy, qx) of
    // R_{J+1} sits at (qy + 1, qx + 1) there
    constexpr int KSTEP = THREADS / CHUNK;
    constexpr int SJ = S + 2;
    const int kg = threadIdx.x / CHUNK;
#pragma unroll
    for (int tp = 0; tp < TAPS; ++tp) {
      const int tap = pass * TAPS + tp;
      const T* src = smem + slot_off(TILE, J) + (qy + tap / 3) * SJ + qx + tap % 3;
#pragma unroll 4
      for (int ci = kg; ci < G; ci += KSTEP)
        A[(tp * G + ci) * CHUNK + p] = src[ci * SJ * SJ];
    }
  }
}

// All products of source J (x for J = 0, else x_J), the slot updates they
// feed, then x_{J+1} in place of c_{J+1} (J < 4) or the output (J = 4).
template <typename T, int TAPS, int J>
__device__ __forceinline__ void run_source(T* smem, const T* __restrict__ x,
                                           T* __restrict__ out,
                                           const Weights& wts, int b, int H,
                                           int W, int oy0, int ox0) {
  using C = Cfg<T, TAPS>;
  constexpr int TILE = C::TILE;
  constexpr int CHUNK = C::CHUNK;
  constexpr int PT = C::PT;
  constexpr int MAXT = C::MAXT;
  constexpr int NR = 4 - J;               // rings around the tile in R_{J+1}
  constexpr int S = TILE + 2 * NR;        // side of R_{J+1}
  constexpr int NPIX = S * S;
  constexpr int KP = TAPS * src_cin(J);   // staged row length of one pass
  constexpr int N = src_n(J);
  T* A = smem + slot_off(TILE, 6);
  const float* B = wts.w[J];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pg = lane >> 2;               // pixel group: 4 pixels
  const int cg = lane & 3;                // column group: 8 columns

  for (int i0 = 0; i0 < NPIX; i0 += CHUNK) {
    const int start = first_col(i0, TILE, NR);
    const int ntiles = PT * ((N - start) / WT);
    float acc[MAXT][PIX][COLS];
    zero(acc);

#pragma unroll 1
    for (int pass = 0; pass < 9 / TAPS; ++pass) {
      __syncthreads();                    // the last product is done with A
      stage<T, TAPS, TILE, CHUNK, J>(A, smem, x, pass, i0, b, H, W, oy0, ox0);
      __syncthreads();
#pragma unroll
      for (int ti = 0; ti < MAXT; ++ti) {
        const int t = warp + ti * NWARPS;
        if (t < ntiles)
          product<T, CHUNK>(A, KP, B + (size_t)pass * KP * N, N,
                            (t % PT) * WT + pg * PIX,
                            start + (t / PT) * WT + cg * COLS, acc[ti]);
      }
    }

#pragma unroll
    for (int ti = 0; ti < MAXT; ++ti) {
      const int t = warp + ti * NWARPS;
      if (t >= ntiles) continue;
      const int c0 = start + (t / PT) * WT + cg * COLS;
      // the lane's 8 columns lie in one slot: c5 below NF, else c_k
      const int k = c0 < NF ? 5 : 4 - (c0 - NF) / G;
      const int ch0 = c0 < NF ? c0 : (c0 - NF) % G;
      const int o = k - J - 1;            // R_k's corner in R_{J+1}
      const int sk = side(TILE, k);
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        const int idx = i0 + (t % PT) * WT + pg * PIX + i;
        if (idx >= NPIX) continue;
        int qy, qx;
        ring_coords(idx, TILE, NR, qy, qx);
        if (qy < o || qy >= o + sk || qx < o || qx >= o + sk) continue;
        T* slot = smem + slot_off(TILE, k) + ch0 * sk * sk + (qy - o) * sk +
                  (qx - o);
        if constexpr (J < 4) {
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const float v = rnd<T>(acc[ti][i][c]);
            T* d = slot + c * sk * sk;
            *d = from_f<T>(J == 0 ? v : to_f(*d) + v);
          }
        } else {
          // out = 0.2 * (x5 + b5) + x over the tile, inside the image
          const int gy = oy0 + qy, gx = ox0 + qx;
          if (gy >= H || gx >= W) continue;
          const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const float x5 = rnd<T>(to_f(slot[c * sk * sk]) +
                                    rnd<T>(acc[ti][i][c]));
            const float y = __fadd_rn(
                __fmul_rn(__fadd_rn(x5, wts.b5[ch0 + c]), 0.2f),
                to_f(x[pix * NF + ch0 + c]));
            out[pix * NF + ch0 + c] = from_f<T>(y);
          }
        }
      }
    }
  }

  if constexpr (J < 4) {
    __syncthreads();
    activate<T, TILE, J + 1>(smem, wts.b14, H, W, oy0, ox0);
    // the next source's first pass syncs before it reads x_{J+1}
  }
}

template <typename T, int TAPS>
__global__ void __launch_bounds__(THREADS, 1)
ladder_kernel(const T* __restrict__ x, T* __restrict__ out, Weights wts,
              int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int TILE = Cfg<T, TAPS>::TILE;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TILE;
  const int ox0 = blockIdx.x * TILE;
  run_source<T, TAPS, 0>(smem, x, out, wts, b, H, W, oy0, ox0);
  run_source<T, TAPS, 1>(smem, x, out, wts, b, H, W, oy0, ox0);
  run_source<T, TAPS, 2>(smem, x, out, wts, b, H, W, oy0, ox0);
  run_source<T, TAPS, 3>(smem, x, out, wts, b, H, W, oy0, ox0);
  run_source<T, TAPS, 4>(smem, x, out, wts, b, H, W, oy0, ox0);
}

// --- v1: the K-packed concat form ------------------------------------------

// Stage row dy of the growth buffer for stage K (2..5) at the chunk of R_K
// starting at pixel i0: A[dx*LANES + l][p] holds lane l = 32*(s-1) + c of
// x_s for s < K, and zero in the lanes of x_K..x4 (their weight rows are
// zero too).
template <typename T, int TILE, int CHUNK, int K>
__device__ __forceinline__ void v1_stage_g(T* __restrict__ A, const T* smem,
                                           int dy, int i0) {
  constexpr int S = side(TILE, K);
  constexpr int KSTEP = THREADS / CHUNK;
  const int p = threadIdx.x % CHUNK;
  const int kg = threadIdx.x / CHUNK;
  // a pixel past the region repeats the last one; its outputs are dropped
  const int i = min(i0 + p, S * S - 1);
  const int qy = i / S, qx = i % S;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll 4
    for (int l = kg; l < LANES; l += KSTEP) {
      const int s = l / G + 1;
      T v = from_f<T>(0.f);
      if (s < K) {
        // pixel (qy, qx) of R_K sits at (qy + K - s, qx + K - s) in R_s
        const int ss = side(TILE, s), o = K - s - 1;
        v = smem[slot_off(TILE, s) + (l % G) * ss * ss + (qy + o + dy) * ss +
                 qx + o + dx];
      }
      A[(dx * LANES + l) * CHUNK + p] = v;
    }
  }
}

// Stage 1: [p1|p2|p3|p4|p5] = conv(x, wx) over R_1 in output chunks of 64
// columns; p_k (k < 5) rounded into slot k over R_k, p5 in float32 over the
// tile. Then x1 = lrelu(p1 + b1) in place.
template <typename T>
__device__ __forceinline__ void v1_stage1(T* smem, float* p5, T* A,
                                          const T* __restrict__ x,
                                          const Weights& wts, int b, int H,
                                          int W, int oy0, int ox0) {
  using C = V1Cfg<T>;
  constexpr int TILE = C::TILE;
  constexpr int CHUNK = C::CHUNK;
  constexpr int PT = C::PT;
  constexpr int MAXT = C::MAXT;
  constexpr int S = side(TILE, 1);
  constexpr int NPIX = S * S;
  constexpr int N = src_n(0);
  constexpr int NT = PT * (V1_COLS / WT);  // warp tiles of one output chunk
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pg = lane >> 2;
  const int cg = lane & 3;
  const int p = threadIdx.x % CHUNK;

  for (int i0 = 0; i0 < NPIX; i0 += CHUNK) {
    const int i = i0 + p;
    const int gy0 = oy0 - 4 + i / S - 1, gx0 = ox0 - 4 + i % S - 1;
#pragma unroll 1
    for (int c0 = 0; c0 < N; c0 += V1_COLS) {
      float acc[MAXT][PIX][COLS];
      zero(acc);
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        __syncthreads();                  // the last product is done with A
        stage_x<T, 3, CHUNK>(A, x, dy, i < NPIX, gy0, gx0, b, H, W);
        __syncthreads();
#pragma unroll
        for (int ti = 0; ti < MAXT; ++ti) {
          const int t = warp + ti * NWARPS;
          if (t >= NT) continue;
          // wx rows (dy, dx, lane): x's 64 channels of each dx
#pragma unroll 1
          for (int dx = 0; dx < 3; ++dx)
            product<T, CHUNK>(A + dx * NF * CHUNK, NF,
                              wts.w[0] + (size_t)(dy * 3 + dx) * LANES * N, N,
                              (t % PT) * WT + pg * PIX,
                              c0 + (t / PT) * WT + cg * COLS, acc[ti]);
        }
      }
#pragma unroll
      for (int ti = 0; ti < MAXT; ++ti) {
        const int t = warp + ti * NWARPS;
        if (t >= NT) continue;
        const int col = c0 + (t / PT) * WT + cg * COLS;
        const int k = col / G + 1 < 5 ? col / G + 1 : 5;
        const int ch0 = col - (k - 1) * G;
        const int o = k - 1;              // R_k's corner in R_1
        const int sk = side(TILE, k);
#pragma unroll
        for (int e = 0; e < PIX; ++e) {
          const int idx = i0 + (t % PT) * WT + pg * PIX + e;
          if (idx >= NPIX) continue;
          const int qy = idx / S - o, qx = idx % S - o;
          if (qy < 0 || qy >= sk || qx < 0 || qx >= sk) continue;
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            if (k < 5)
              smem[slot_off(TILE, k) + (ch0 + c) * sk * sk + qy * sk + qx] =
                  from_f<T>(acc[ti][e][c]);
            else
              p5[(ch0 + c) * TILE * TILE + qy * TILE + qx] = acc[ti][e][c];
          }
        }
      }
    }
  }
  __syncthreads();
  activate<T, TILE, 1>(smem, wts.b14, H, W, oy0, ox0);
}

// Stage K (2..5): conv(g, wg_K) over R_K on all 128 lanes, then
// x_K = lrelu((p_K + conv) + b_K) in place of p_K (K < 5, zero outside the
// image), or out = 0.2 * ((p5 + conv) + b5) + x over the tile (K = 5).
template <typename T, int K>
__device__ __forceinline__ void v1_stage(T* smem, const float* p5, T* A,
                                         const T* __restrict__ x,
                                         T* __restrict__ out,
                                         const Weights& wts, int b, int H,
                                         int W, int oy0, int ox0) {
  using C = V1Cfg<T>;
  constexpr int TILE = C::TILE;
  constexpr int CHUNK = C::CHUNK;
  constexpr int PT = C::PT;
  constexpr int MAXT = C::MAXT;
  constexpr int S = side(TILE, K);
  constexpr int NPIX = S * S;
  constexpr int N = slot_chans(K);
  constexpr int KP = 3 * LANES;           // staged rows of one dy
  constexpr int NT = PT * (N / WT);
  const float* B = wts.w[K - 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pg = lane >> 2;
  const int cg = lane & 3;

  for (int i0 = 0; i0 < NPIX; i0 += CHUNK) {
    float acc[MAXT][PIX][COLS];
    zero(acc);
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
      __syncthreads();
      v1_stage_g<T, TILE, CHUNK, K>(A, smem, dy, i0);
      __syncthreads();
#pragma unroll
      for (int ti = 0; ti < MAXT; ++ti) {
        const int t = warp + ti * NWARPS;
        if (t < NT)
          product<T, CHUNK>(A, KP, B + (size_t)dy * KP * N, N,
                            (t % PT) * WT + pg * PIX,
                            (t / PT) * WT + cg * COLS, acc[ti]);
      }
    }
#pragma unroll
    for (int ti = 0; ti < MAXT; ++ti) {
      const int t = warp + ti * NWARPS;
      if (t >= NT) continue;
      const int c0 = (t / PT) * WT + cg * COLS;
#pragma unroll
      for (int e = 0; e < PIX; ++e) {
        const int idx = i0 + (t % PT) * WT + pg * PIX + e;
        if (idx >= NPIX) continue;
        const int qy = idx / S, qx = idx % S;
        if constexpr (K < 5) {
          const int gy = oy0 - (5 - K) + qy, gx = ox0 - (5 - K) + qx;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          T* d = smem + slot_off(TILE, K) + c0 * NPIX + idx;
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const float v = lrelu(__fadd_rn(
                __fadd_rn(to_f(d[c * NPIX]), acc[ti][e][c]),
                wts.b14[(K - 1) * G + c0 + c]));
            d[c * NPIX] = from_f<T>(inside ? v : 0.f);
          }
        } else {
          const int gy = oy0 + qy, gx = ox0 + qx;
          if (gy >= H || gx >= W) continue;
          const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const float x5 = __fadd_rn(
                __fadd_rn(p5[(c0 + c) * NPIX + idx], acc[ti][e][c]),
                wts.b5[c0 + c]);
            const float y = __fadd_rn(__fmul_rn(x5, 0.2f),
                                      to_f(x[pix * NF + c0 + c]));
            out[pix * NF + c0 + c] = from_f<T>(y);
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
v1_kernel(const T* __restrict__ x, T* __restrict__ out, Weights wts, int H,
          int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = V1Cfg<T>::TILE;
  // [slots 1..4 (storage dtype) | p5 (float32) | staging]
  T* smem = reinterpret_cast<T*>(smem_raw);
  float* p5 = reinterpret_cast<float*>(smem_raw + slot_off(TILE, 5) * sizeof(T));
  T* A = reinterpret_cast<T*>(p5 + NF * TILE * TILE);
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TILE;
  const int ox0 = blockIdx.x * TILE;
  v1_stage1<T>(smem, p5, A, x, wts, b, H, W, oy0, ox0);
  v1_stage<T, 2>(smem, p5, A, x, out, wts, b, H, W, oy0, ox0);
  v1_stage<T, 3>(smem, p5, A, x, out, wts, b, H, W, oy0, ox0);
  v1_stage<T, 4>(smem, p5, A, x, out, wts, b, H, W, oy0, ox0);
  v1_stage<T, 5>(smem, p5, A, x, out, wts, b, H, W, oy0, ox0);
}

// --- launch and query --------------------------------------------------------

template <typename T, typename C>
int launch(void (*kernel)(const T*, T*, Weights, int, int), const void* x,
           void* out, const Weights& wts, int B, int H, int W,
           cudaStream_t stream) {
  // set on every launch, so that it holds on whichever device is current;
  // the call costs microseconds against a kernel of milliseconds
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + C::TILE - 1) / C::TILE, (H + C::TILE - 1) / C::TILE, B);
  kernel<<<grid, THREADS, (size_t)C::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), wts, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(int rung, const void* x, void* out, const Weights& wts, int B,
            int H, int W, cudaStream_t st) {
  switch (rung) {
    case 1: return launch<T, V1Cfg<T>>(v1_kernel<T>, x, out, wts, B, H, W, st);
    case 2:
      return launch<T, Cfg<T, 3>>(ladder_kernel<T, 3>, x, out, wts, B, H, W, st);
    case 3:
      return launch<T, Cfg<T, 9>>(ladder_kernel<T, 9>, x, out, wts, B, H, W, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename C>
long long field(int what) {
  switch (what) {
    case 0: return C::TILE;
    case 1: return C::CHUNK;
    case 2: return C::SMEM;
    case 3: return C::macs();
  }
  return -1;
}

template <typename T>
long long query(int rung, int what) {
  switch (rung) {
    case 1: return field<V1Cfg<T>>(what);
    case 2: return field<Cfg<T, 3>>(what);
    case 3: return field<Cfg<T, 9>>(what);
  }
  return -1;
}

}  // namespace

// rung: 1, 2 or 3 (v1, v2, v3); dtype: 0 = float32, 1 = bfloat16.
// x, out: (B, H, W, 64) contiguous, 16-byte aligned; wx, w1..w4: the
// rung's five packed float32 matrices as ops/rdb_ladder.py packs them
// (v1: (3, 3*128, N) rows (dy; dx, lane); v2's (3, 3*Cin, N) and v3's
// (9*Cin, N) rows (dy, dx, cin) are the same memory); b14: 128, b5: 64
// float32. Returns the CUDA error code of the launch (0 = success).
extern "C" int s2sr_rdb_ladder_forward(int rung, const void* x, void* out,
                                       const void* wx, const void* w1,
                                       const void* w2, const void* w3,
                                       const void* w4, const void* b14,
                                       const void* b5, int B, int H, int W,
                                       int dtype, void* stream) {
  const Weights wts = {{static_cast<const float*>(wx),
                        static_cast<const float*>(w1),
                        static_cast<const float*>(w2),
                        static_cast<const float*>(w3),
                        static_cast<const float*>(w4)},
                       static_cast<const float*>(b14),
                       static_cast<const float*>(b5)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(rung, x, out, wts, B, H, W, st);
  if (dtype == 1) return forward<__nv_bfloat16>(rung, x, out, wts, B, H, W, st);
  return (int)cudaErrorInvalidValue;
}

// A rung's tiling by dtype: what = 0 output tile side, 1 pixels per staged
// chunk, 2 dynamic shared-memory bytes per block, 3 multiply-adds executed
// per output tile (halo recompute, padding and v1's zero rows included);
// -1 for an unknown rung, dtype or field.
extern "C" long long s2sr_rdb_ladder_query(int rung, int dtype, int what) {
  if (dtype == 0) return query<float>(rung, what);
  if (dtype == 1) return query<__nv_bfloat16>(rung, what);
  return -1;
}

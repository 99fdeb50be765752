// Fused residual dense block (RDB) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel s2sr_tpu/ops/pallas/fused_rdb_v4.py::rdb_pallas_v4
// (kernel body _kernel_v4). Computes, in one launch per block of the
// network, the function of s2sr_tpu/models/rrdbnet.py::_rdb_packed:
//
//   x1 = m(lrelu(conv1(x)))                 64 -> 32
//   x2 = m(lrelu(conv2([x, x1])))           96 -> 32
//   x3 = m(lrelu(conv3([x, x1, x2])))      128 -> 32
//   x4 = m(lrelu(conv4([x, x1, x2, x3])))  160 -> 32
//   x5 = conv5([x, x1, x2, x3, x4])        192 -> 64
//   out = m(0.2 * x5 + x)
//
// with 3x3 zero-padded SAME convolutions relative to the (B, H, W, 64)
// tensor it is given, LeakyReLU slope 0.2, and m() an optional (B, H, W)
// 0/1 mask that re-zeroes x1..x4 and the output (the exact
// masked-bucket serving path). Storage is float32 or bfloat16; every
// sum accumulates in float32.
//
// What bounds it: operations. One block costs 479,232 FLOP per pixel
// against 256 bytes moved per pixel in bf16, about 1,900 FLOP per byte,
// far above the H100's ~295 FLOP/byte balance point. The design keeps
// the intermediates x1..x4 in shared memory and never writes them to
// device memory (what the TPU kernel keeps out of HBM too), so the
// kernel's time is its arithmetic.
//
// Two kernels, one per storage type, with the same structure: each thread
// block owns one output tile of one image, loads the input with a 5-pixel
// halo into dynamic shared memory (zero outside the image), then computes
// x1..x4 over regions that shrink by one pixel per side per stage (halo
// 4, 3, 2, 1); x5 and the residual over the tile itself go straight to
// device memory.
//
// - bfloat16 (the main path), rdb_wg_kernel: every stage an implicit GEMM
//   on wgmma (bf16 into float32 accumulators) issued by two consumer
//   warpgroups, A from the resident bf16 sources by ldmatrix, B streamed
//   by a producer warpgroup through a ring of bulk copies; 16x16 tiles.
//   Section "the wgmma kernels" below.
// - bfloat16 on mma.sync, rdb_tc_kernel: the same implicit GEMM on Ampere's
//   mma.sync.m16n8k16, every warp loading its own B fragments from L2
//   (200,704 B shared). Served by nothing: the RDB ladder's rung v4_mma
//   (ops/rdb.py::rdb_mma), kept so that one call times both designs.
// - bfloat16 with its x conv in int8, rdb_i8_kernel: the int8-mixed block of
//   precision "int8" (s2sr_tpu/models/rrdbnet_int8.py:224 _rdb_packed_mixed,
//   which JAX runs with XLA's int8 convolution: no Pallas kernel). x is
//   quantized as it is loaded (round half to even of x * qm, clamped to
//   +-127); x's rows run as s8 x s8 into int32, dequantized per output
//   channel into the float32 accumulators before x1..x4 add their bf16
//   products. On wgmma (section "the wgmma kernels" below).
// - the time-attribution instances of the bf16 kernel, rdb_wg_ablate_kernel
//   (the ports of rdb_pallas_v4's staging knobs, never served): the same
//   kernel with its epilogue's stores, its accumulation or its B lookahead
//   taken out (enum Variant below).
// - full W8A8, rdb_w8a8_kernel: every conv input quantized, all five convs
//   int8 (s2sr_tpu/models/rrdbnet_int8.py:169 _rdb_packed_i8, XLA's int8
//   convolution in JAX: no Pallas kernel). Each stage's epilogue stores
//   x1..x4 in shared memory as int8 (round half to even of v * qm[k] after
//   bias, LeakyReLU and the mask; quant(0) = 0 keeps the halo outside the
//   image zero); each source's exact int32 sums are dequantized by its own
//   factors into the float32 accumulators before the next source starts.
//   The all-s8 instance of rdb_i8_kernel's design.
//
//   What bounds the three wgmma kernels on this card: as counted in
//   chip_smoke.py (each input read once, the products at 989 TFLOP/s in
//   bf16, 1,979 TOPS in int8), operations. What bounds the design: shared
//   memory. A wgmma's A (64 rows x 32 bytes) is read from the resident
//   sources by ldmatrix and its B (N rows x 32 bytes) by the tensor cores,
//   so at N = 32 (stages 1-4) each k-step moves 3 KB of shared memory for
//   64 x 32 x 32 s8 or 64 x 32 x 16 bf16 multiply-adds (16 tensor-core
//   clocks either way): at 128 B a clock that is 24 clocks against 16
//   (67%); at N = 64 (stage 5) 4 KB against 32 (100%). The design keeps x and
//   x1..x4 resident (no copy of A a step), streams B by bulk copies that
//   no thread issues but one, and keeps a k-step's products in flight
//   while the next k-step's A loads.
// - float32 (precision "float32"), rdb_f32_wg_kernel: every stage an
//   implicit GEMM on wgmma in split TF32 ("3xTF32"): each float32 operand
//   split into two TF32 values, three TF32 products a multiply-add, so the
//   sums keep float32's accuracy; the sources resident in float32, B
//   streamed as hi and lo slabs through a ring of bulk copies; 8x8 tiles.
//   Section "float32 on wgmma" below.
// - float32 on the CUDA cores, rdb_kernel<float, 8>: the float32 design
//   before it, served by nothing (ops/rdb.py::rdb_ffma, the timing
//   baseline). float32 FMA, 8x8 tiles (172,032 B shared), the sources planar
//   [channel][y][x] so that the 32 lanes of a warp read 32 neighbouring
//   pixels of one channel without bank conflicts. A warp task is 128
//   pixels (4 per lane) x 16 output channels: per (tap, input channel) a
//   lane does 4 shared loads, 4 uniform 16-byte weight loads (broadcast
//   from L1/L2) and 64 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 64;        // features
constexpr int G = 32;         // growth channels
constexpr int HALO = 5;       // one pixel per 3x3 conv stage
constexpr int THREADS = 256;
constexpr int PIX = 4;        // pixels per lane in a warp task
constexpr int COG = 16;       // output channels per warp task

__host__ __device__ constexpr int stage_cin(int s) { return NF + (s - 1) * G; }
__host__ __device__ constexpr int stage_cout(int s) { return s < 5 ? G : NF; }
__host__ __device__ constexpr int stage_woff(int s) {
  int off = 0;
  for (int k = 1; k < s; ++k) off += 9 * stage_cin(k) * stage_cout(k);
  return off;
}
__host__ __device__ constexpr int src_chans(int j) { return j == 0 ? NF : G; }
__host__ __device__ constexpr int src_side(int tile, int j) {
  return tile + 2 * (HALO - j);
}
// element offset of source buffer j (0 = x, 1..4 = x1..x4) in shared memory
__host__ __device__ constexpr int src_off(int tile, int j) {
  int off = 0;
  for (int k = 0; k < j; ++k)
    off += src_chans(k) * src_side(tile, k) * src_side(tile, k);
  return off;
}

// the CUDA-core kernel below is instantiated for float32 only
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// One conv stage S (1..5) over the sources 0..S-1 held in shared memory.
template <typename T, int TILE, int S>
__device__ __forceinline__ void run_stage(
    T* smem, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ mask, T* __restrict__ out, int b, int H, int W,
    int oy0, int ox0) {
  constexpr int HS = HALO - S;          // halo of this stage's region
  constexpr int RS = TILE + 2 * HS;
  constexpr int NPIX = RS * RS;
  constexpr int COUT = stage_cout(S);
  constexpr int CIN = stage_cin(S);
  constexpr int PGROUP = 32 * PIX;
  constexpr int NPG = (NPIX + PGROUP - 1) / PGROUP;
  constexpr int NCG = COUT / COG;
  constexpr int NTASK = NPG * NCG;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* ws = w + stage_woff(S);
  const size_t img_off = (size_t)b * H * W;

  for (int task = warp; task < NTASK; task += THREADS / 32) {
    const int pg = task / NCG;
    const int co0 = (task % NCG) * COG;
    int py[PIX], px[PIX];
    bool valid[PIX];
#pragma unroll
    for (int jj = 0; jj < PIX; ++jj) {
      const int p = pg * PGROUP + jj * 32 + lane;
      valid[jj] = p < NPIX;
      const int pc = valid[jj] ? p : NPIX - 1;
      py[jj] = pc / RS;
      px[jj] = pc % RS;
    }
    float acc[PIX][COG];
#pragma unroll
    for (int jj = 0; jj < PIX; ++jj)
#pragma unroll
      for (int q = 0; q < COG; ++q) acc[jj][q] = 0.f;

    int ci_base = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int rj = src_side(TILE, j);
      const int aj = rj * rj;
      const int cj = src_chans(j);
      const int d = S - j - 1;          // region offset of source j
      const T* sb = smem + src_off(TILE, j);
      int base[PIX];
#pragma unroll
      for (int jj = 0; jj < PIX; ++jj) base[jj] = (py[jj] + d) * rj + px[jj] + d;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * rj + (tap % 3);
        const float* wt = ws + ((size_t)tap * CIN + ci_base) * COUT + co0;
#pragma unroll 4
        for (int ci = 0; ci < cj; ++ci) {
          const T* sc = sb + ci * aj + toff;
          float xv[PIX];
#pragma unroll
          for (int jj = 0; jj < PIX; ++jj) xv[jj] = to_f(sc[base[jj]]);
          const float4* wp = reinterpret_cast<const float4*>(wt + ci * COUT);
          float wv[COG];
#pragma unroll
          for (int q4 = 0; q4 < COG / 4; ++q4) {
            const float4 t = __ldg(wp + q4);
            wv[4 * q4 + 0] = t.x;
            wv[4 * q4 + 1] = t.y;
            wv[4 * q4 + 2] = t.z;
            wv[4 * q4 + 3] = t.w;
          }
#pragma unroll
          for (int jj = 0; jj < PIX; ++jj)
#pragma unroll
            for (int q = 0; q < COG; ++q)
              acc[jj][q] = fmaf(xv[jj], wv[q], acc[jj][q]);
        }
      }
      ci_base += cj;
    }

    float bv[COG];
#pragma unroll
    for (int q = 0; q < COG; ++q) bv[q] = __ldg(bias + (S - 1) * G + co0 + q);

    if constexpr (S < 5) {
      // x_S = m(lrelu(acc + b)), zero outside the image (SAME padding
      // of the next convs), stored to shared memory
      T* dst = smem + src_off(TILE, S);
#pragma unroll
      for (int jj = 0; jj < PIX; ++jj) {
        if (!valid[jj]) continue;
        const int gy = oy0 - HS + py[jj];
        const int gx = ox0 - HS + px[jj];
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float m = !inside ? 0.f
                        : (mask ? mask[img_off + (size_t)gy * W + gx] : 1.f);
        const int p = py[jj] * RS + px[jj];
#pragma unroll
        for (int q = 0; q < COG; ++q) {
          float v = acc[jj][q] + bv[q];
          v = v >= 0.f ? v : 0.2f * v;
          v = inside ? v * m : 0.f;
          dst[(co0 + q) * NPIX + p] = from_f<T>(v);
        }
      }
    } else {
      // out = m(0.2 * x5 + x) over the output tile
      constexpr int R0 = TILE + 2 * HALO;
      constexpr int A0 = R0 * R0;
#pragma unroll
      for (int jj = 0; jj < PIX; ++jj) {
        if (!valid[jj]) continue;
        const int gy = oy0 + py[jj];
        const int gx = ox0 + px[jj];
        if (gy >= H || gx >= W) continue;
        const size_t pix = img_off + (size_t)gy * W + gx;
        const float m = mask ? mask[pix] : 1.f;
        const int p0 = (py[jj] + HALO) * R0 + px[jj] + HALO;
        T* o = out + pix * NF + co0;
#pragma unroll
        for (int q = 0; q < COG; ++q) {
          const float xin = to_f(smem[(co0 + q) * A0 + p0]);
          const float v = (acc[jj][q] + bv[q]) * 0.2f + xin;
          o[q] = from_f<T>(v * m);
        }
      }
    }
  }
}

template <typename T, int TILE>
__global__ void __launch_bounds__(THREADS)
rdb_kernel(const T* __restrict__ x, const float* __restrict__ mask,
           T* __restrict__ out, const float* __restrict__ w,
           const float* __restrict__ bias, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TILE;
  const int ox0 = blockIdx.x * TILE;
  const size_t img_off = (size_t)b * H * W;

  {
    // input tile + 5-px halo, zero outside the image; channel-fastest
    // iteration keeps the NHWC global reads coalesced
    constexpr int R = TILE + 2 * HALO;
    constexpr int A = R * R;
    for (int i = threadIdx.x; i < A * NF; i += THREADS) {
      const int c = i % NF;
      const int p = i / NF;
      const int gy = oy0 - HALO + p / R;
      const int gx = ox0 - HALO + p % R;
      T v = from_f<T>(0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = x[(img_off + (size_t)gy * W + gx) * NF + c];
      smem[c * A + p] = v;
    }
  }
  __syncthreads();
  run_stage<T, TILE, 1>(smem, w, bias, mask, out, b, H, W, oy0, ox0);
  __syncthreads();
  run_stage<T, TILE, 2>(smem, w, bias, mask, out, b, H, W, oy0, ox0);
  __syncthreads();
  run_stage<T, TILE, 3>(smem, w, bias, mask, out, b, H, W, oy0, ox0);
  __syncthreads();
  run_stage<T, TILE, 4>(smem, w, bias, mask, out, b, H, W, oy0, ox0);
  __syncthreads();
  run_stage<T, TILE, 5>(smem, w, bias, mask, out, b, H, W, oy0, ox0);
}

template <typename T, int TILE>
constexpr size_t smem_bytes() {
  return (size_t)src_off(TILE, 5) * sizeof(T);
}

template <typename T, int TILE>
int launch(const void* x, const void* mask, void* out, const void* w,
           const void* bias, int B, int H, int W, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, TILE>();
  // set on every launch, so that it holds on whichever device is current;
  // the call costs microseconds against a kernel of milliseconds
  const cudaError_t e = cudaFuncSetAttribute(
      rdb_kernel<T, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  rdb_kernel<T, TILE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<T*>(out), static_cast<const float*>(w),
      static_cast<const float*>(bias), H, W);
  return (int)cudaGetLastError();
}

constexpr int TILE_F32 = 8;

// --- bf16 on mma.sync: rdb_tc_kernel, the ladder's v4_mma -------------------
//
// The main path's kernel from its redesign onto the tensor cores until the
// wgmma kernel below took its place; served by nothing now.
//
// Each conv stage is a product of the im2col matrix of its region (pixels x
// 9 * Cin) with the weights (9 * Cin x Cout) on mma.sync.m16n8k16 (bf16 in,
// float32 accumulators), without an im2col copy. The sources x, x1..x4 stay
// in shared memory pixel-major (NHWC, channels contiguous) with an XOR
// swizzle on the 16-byte chunk index: chunk q of a buffer is stored at
// q ^ ((q >> 3) & 7) in its low three bits, so the 8 pixels of one ldmatrix
// phase hit 8 different chunks of a 128-byte line (x has 8 chunks a pixel,
// x1..x4 four). A k16 slab of the im2col matrix is one (source, tap, 16
// channels): ldmatrix.x4 takes one row address a lane, and lane l points
// at its pixel (l % 16 of the M tile) shifted by the tap, at channel chunk
// 2c + l / 16. The 16 pixels of an M tile may span two rows of the region.
// The weights come packed by the wrapper in the B-fragment order of the
// slabs the kernel walks (ops/rdb.py::pack_rdb_fragments), one 16-byte load
// a lane for 16 output channels, loaded one slab ahead from L2.
//
// A stage's M tiles (16 region pixels each) are dealt to the 8 warps in
// turn, warp w taking tiles w, w + 8, ...; a warp keeps the accumulators of
// all its tiles and all output channels, so each B fragment serves MT M
// tiles and each A fragment all the channels. Every output is a sum over
// the same slabs in the same order wherever its pixel lies (tile, batch,
// image), which the serving contracts need.

constexpr int TC_TILE = 16;
constexpr int TC_WARPS = 8;

__host__ __device__ constexpr int tc_side(int j) { return TC_TILE + 2 * (HALO - j); }
// byte offset of source buffer j (0 = x, 1..4 = x1..x4), each a multiple of
// 128 bytes; with i8, x is stored as int8 (one byte a value)
__host__ __device__ constexpr int tc_off(int j, bool i8 = false) {
  int off = 0;
  for (int k = 0; k < j; ++k)
    off += tc_side(k) * tc_side(k) * src_chans(k) * (i8 && k == 0 ? 1 : 2);
  return off;
}
// M tiles of stage s's region, and the most a warp takes
__host__ __device__ constexpr int tc_mtiles(int s) {
  return (tc_side(s) * tc_side(s) + 15) / 16;
}
__host__ __device__ constexpr int tc_mt(int s) {
  return (tc_mtiles(s) + TC_WARPS - 1) / TC_WARPS;
}
// uint4s (per lane, 32 lanes) of the packed weights before stage s
__host__ __device__ constexpr int tc_woff(int s) {
  int off = 0;
  for (int k = 1; k < s; ++k) off += 9 * stage_cin(k) / 16 * stage_cout(k) / 16 * 32;
  return off;
}

// column of stage s's output channel 0 in the packed 64 -> 192 x conv,
// whose columns are [a5 | a4 | a3 | a2 | a1] (rrdbnet.py::packed_prefix_kernels)
__host__ __device__ constexpr int i8_col(int s) {
  return s == 5 ? 0 : NF + (4 - s) * G;
}

__device__ __forceinline__ uint32_t swz(uint32_t q) { return q ^ ((q >> 3) & 7); }

__device__ __forceinline__ void tc_ldmatrix(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void tc_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round(v * qm) clamped to +-127 as int8 in the low byte: jnp.round is
// round half to even, as rintf
__device__ __forceinline__ uint32_t quant1(float v, float qm) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, qm)), -127.f), 127.f);
  return (uint32_t)(int)q & 0xffu;
}

// four bf16 values (two words, lower channel in the low half) -> four int8
__device__ __forceinline__ uint32_t quant4(uint32_t lo, uint32_t hi, float qm) {
  return quant1(__uint_as_float(lo << 16), qm)
         | quant1(__uint_as_float(lo & 0xffff0000u), qm) << 8
         | quant1(__uint_as_float(hi << 16), qm) << 16
         | quant1(__uint_as_float(hi & 0xffff0000u), qm) << 24;
}

// One conv stage S (1..5) on mma.sync.
template <int S>
__device__ __forceinline__ void tc_stage(uint32_t sbase, const uint4* __restrict__ wf,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ mask,
                                         __nv_bfloat16* __restrict__ out,
                                         int b, int H, int W, int oy0, int ox0) {
  constexpr int RS = tc_side(S);          // region side of this stage
  constexpr int NPIX = RS * RS;
  constexpr int NT = tc_mtiles(S);
  constexpr int MT = tc_mt(S);
  constexpr int COUT = stage_cout(S);
  constexpr int NB = COUT / 16;           // 16-channel blocks: one uint4 each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint4* ws = wf + tc_woff(S) + lane;

  // this lane's ldmatrix pixel in each of the warp's M tiles
  int py[MT], px[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    int p = (warp + TC_WARPS * m) * 16 + (lane & 15);
    p = p < NPIX ? p : NPIX - 1;
    py[m] = p / RS;
    px[m] = p % RS;
  }
  float acc[MT][2 * NB][4];
  int slab = 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  uint4 bcur[NB], bnext[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) bcur[n] = __ldg(ws + (slab * NB + n) * 32);
  constexpr int NSLAB = 9 * stage_cin(S) / 16;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int rj = tc_side(j);
    const int cq = src_chans(j) / 8;      // 16-byte chunks a pixel
    const int d = S - 1 - j;              // the region's offset in source j
    const uint32_t base = sbase + tc_off(j);
    int sp0[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) sp0[m] = (py[m] + d) * rj + px[m] + d;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * rj + tap % 3;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= src_chans(j) / 16) break;
        {
          const int nxt = slab + 1 < NSLAB ? slab + 1 : slab;
#pragma unroll
          for (int n = 0; n < NB; ++n) bnext[n] = __ldg(ws + (nxt * NB + n) * 32);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (warp + TC_WARPS * m >= NT) break;
          const uint32_t q = (uint32_t)(sp0[m] + toff) * cq + 2 * c + (lane >> 4);
          uint32_t a[4];
          tc_ldmatrix(a, base + swz(q) * 16);
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            tc_mma(acc[m][2 * n], a, bcur[n].x, bcur[n].y);
            tc_mma(acc[m][2 * n + 1], a, bcur[n].z, bcur[n].w);
          }
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) bcur[n] = bnext[n];
        ++slab;
      }
    }
  }

  // epilogue: accumulator (m, n8 tile k, e) is region pixel (tile, g + 8(e/2))
  // at channel 8k + 2t + e % 2
  const size_t img_off = (size_t)b * H * W;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (warp + TC_WARPS * m >= NT) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (warp + TC_WARPS * m) * 16 + g + 8 * h;
      if (p >= NPIX) continue;
      const int ry = p / RS, rx = p % RS;
      if constexpr (S < 5) {
        constexpr int HS = HALO - S;
        const int gy = oy0 - HS + ry, gx = ox0 - HS + rx;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float mk = !inside ? 0.f
                         : (mask ? mask[img_off + (size_t)gy * W + gx] : 1.f);
        // x_S at its own region's pixel p: 4 chunks a pixel
        const uint32_t dst = sbase + tc_off(S);
#pragma unroll
        for (int k = 0; k < 2 * NB; ++k) {
          const int co = 8 * k + 2 * t;
          float v0 = acc[m][k][2 * h] + __ldg(bias + (S - 1) * G + co);
          float v1 = acc[m][k][2 * h + 1] + __ldg(bias + (S - 1) * G + co + 1);
          v0 = (v0 >= 0.f ? v0 : 0.2f * v0) * mk;
          v1 = (v1 >= 0.f ? v1 : 0.2f * v1) * mk;
          if (!inside) v0 = v1 = 0.f;
          const __nv_bfloat162 pr = __floats2bfloat162_rn(v0, v1);
          const uint32_t q = (uint32_t)p * 4 + k;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + swz(q) * 16 + 4 * t),
                       "r"(*reinterpret_cast<const uint32_t*>(&pr)) : "memory");
        }
      } else {
        const int gy = oy0 + ry, gx = ox0 + rx;
        if (gy >= H || gx >= W) continue;
        const size_t pix = img_off + (size_t)gy * W + gx;
        const float mk = mask ? mask[pix] : 1.f;
        // x at the same pixel: region 0 has a 5-pixel halo, 8 chunks a pixel
        const int xp = (ry + HALO) * tc_side(0) + rx + HALO;
#pragma unroll
        for (int k = 0; k < 2 * NB; ++k) {
          const int co = 8 * k + 2 * t;
          uint32_t xin;
          const uint32_t q = (uint32_t)xp * 8 + k;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(xin)
                       : "r"(sbase + swz(q) * 16 + 4 * t) : "memory");
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xin));
          const float v0 = (acc[m][k][2 * h] + __ldg(bias + 4 * G + co)) * 0.2f + xf.x;
          const float v1 = (acc[m][k][2 * h + 1] + __ldg(bias + 4 * G + co + 1)) * 0.2f + xf.y;
          const __nv_bfloat162 pr = __floats2bfloat162_rn(v0 * mk, v1 * mk);
          *reinterpret_cast<__nv_bfloat162*>(out + pix * NF + co) = pr;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(TC_WARPS * 32, 1)
rdb_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mask,
              __nv_bfloat16* __restrict__ out, const uint4* __restrict__ wf,
              const float* __restrict__ bias, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TC_TILE, ox0 = blockIdx.x * TC_TILE;
  const size_t img_off = (size_t)b * H * W;
  {
    // input tile + 5-px halo, 16-byte cp.async copies, zero-filled outside
    // the image (a source size of 0 reads nothing)
    constexpr int R = tc_side(0);
    for (int i = threadIdx.x; i < R * R * 8; i += TC_WARPS * 32) {
      const int p = i >> 3, c = i & 7;
      const int gy = oy0 - HALO + p / R, gx = ox0 - HALO + p % R;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const __nv_bfloat16* src =
          in ? x + (img_off + (size_t)gy * W + gx) * NF + 8 * c : x;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(sbase + swz((uint32_t)i) * 16), "l"(src), "r"(in ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();
  tc_stage<1>(sbase, wf, bias, mask, out, b, H, W, oy0, ox0);
  __syncthreads();
  tc_stage<2>(sbase, wf, bias, mask, out, b, H, W, oy0, ox0);
  __syncthreads();
  tc_stage<3>(sbase, wf, bias, mask, out, b, H, W, oy0, ox0);
  __syncthreads();
  tc_stage<4>(sbase, wf, bias, mask, out, b, H, W, oy0, ox0);
  __syncthreads();
  tc_stage<5>(sbase, wf, bias, mask, out, b, H, W, oy0, ox0);
}

// --- the wgmma kernels: rdb_wg_kernel, rdb_i8_kernel, rdb_w8a8_kernel -------
//
// Each conv stage is the implicit GEMM of rdb_tc_kernel, issued by two
// consumer warpgroups (4 warps each) as wgmma.mma_async with 64-row M tiles:
// m64nNk16 bf16 into float32 for every bf16 source (all of rdb_wg's, rdb_i8's
// x1..x4), m64nNk32 s8 x s8 into int32 for every s8 source; N is the
// stage's Cout (32, or 64 in stage 5). The three kernels differ in what
// they hold resident and how their sums are scaled (enum Kind).
//
// A comes from registers. Each warp's 16 rows of a tile are 16 region
// pixels, loaded by ldmatrix.x4 from the resident sources at the tap's shift
// (wgmma's register layout of A is mma.sync's A fragment). Chosen over A by
// descriptor from shared memory: a descriptor's 8-row core matrices must be
// 8 pixels a constant stride apart, so its M tile is an 8 x 8 patch
// (executed / useful 1.67, against 1.48 here) and a tap's dx shift moves the
// start off the swizzle atom (the base-offset field); the register route
// takes any tap shift from any pixel. The resident sources are laid out so
// that an ldmatrix phase hits 8 bank groups from any first pixel (rot).
//
// B comes from shared memory by descriptor. The wrapper packs each stage's
// rows of B once, as slabs of KQ k-steps in wgmma's K-major layout with the
// 128-byte swizzle (row n of a slab is output channel n, 4 k-steps of 32
// bytes; its 16-byte chunk c at c ^ (n % 8); 8-row groups 1024 bytes apart),
// and a producer warpgroup streams them in the order the consumers read them
// through a ring of NBUF slots: one cp.async.bulk a slab by one thread,
// completing on the slot's `full` mbarrier; the consumers arrive on its
// `empty` mbarrier once their wgmmas on it have completed, and the producer
// refills it NBUF slabs ahead. No consumer loads B.
//
// The pipeline (wg_run): per k-step, ldmatrix of its A into one of two
// register sets, wgmma.fence, one wgmma a tile, commit; then wait_group 1,
// so that a step's products run while the next step's A loads. An s8
// source's sums start from zeroed registers; after its last step,
// wait_group 0 and they are dequantized per output channel into the float32
// accumulators (exact: |sum| <= 127 * 127 * 576 < 2^24): rdb_i8 before
// x1..x4 add their bf16 products, rdb_w8a8 before the next source starts.
// rdb_wg's sums are bf16 products into float32 from zeroed registers, x's
// 36 k-steps (four a tap) and then x1..x_{s-1}'s 18 each, in that order for
// every pixel. Both warpgroups run the same number of M tiles (a branch on
// the warpgroup would serialise the wgmmas): tile w + 2m for warpgroup w;
// rows past the region load its last pixel and are dropped. So every output
// sums the same slabs in the same order with the same wgmma shape wherever
// its pixel lies (tile, batch, image, sp band): the serving contracts. ptxas
// keeps the wgmmas in flight together only in wg_run's shape; chip_smoke.py
// fails on any wgmma note of ptxas for the served kernels.
//
// A block: 384 threads (launch bounds 384, 1 block an SM); setmaxnreg gives
// the consumers 240 registers a thread and the producer warpgroup 24.
// Shared memory: the ring (nbuf x 8 KB), the resident sources and a full
// and an empty mbarrier a slot (wg_smem_bytes): 224,128 bytes for rdb_i8,
// 167,040 for rdb_w8a8 (8 slots), and for rdb_wg, whose sources are all
// bf16 (x 26 * 26 * 128 = 86,528, x1..x4 36,864 + 30,976 + 25,600 + 20,736:
// 200,704), 1,024 + 3 * 8,192 + 200,704 + 48 = 226,352 of the block's
// 232,448. Eight slots would make 267,392. The plans that fit were (a) this
// one, 3 slots of 8 KB at tile 16; (b) 7 slots of 4 KB at tile 16, stage 5
// as two N = 32 halves (230,512 B); (c) tile 14 with 8 slots (225,904 B,
// 19^2 = 361 blocks an image instead of 17^2 = 289, and more halo). (a) keeps
// the design of the int8 kernels whole; three slots leave the producer one
// slab of lookahead past the two a consumer may hold (the one it reads and
// the one whose last step may still run), and the ablation SERIAL_B (enum
// Variant) measures what that lookahead is worth.

constexpr int WGS = TC_WARPS / 4;        // consumer warpgroups a block
constexpr int WG_THREADS = TC_WARPS * 32 + 128;  // and a producer warpgroup
constexpr int KQ = 4;                    // k-steps a slab: 128 bytes of K a row
constexpr int NBUF = 8;                  // slots of the int8 kernels' B ring
constexpr int NBUF_BF16 = 3;             // slots of rdb_wg's
constexpr int SLOT = 64 * 128;           // bytes a slot: one slab at N 64

// The three kernels of this design: what they hold and how they sum.
// KI8 rdb_i8 (x in s8, x1..x4 in bf16), KW8 rdb_w8a8 (all in s8), KBF rdb_wg
// (all in bf16).
enum Kind : int { KI8 = 0, KW8 = 1, KBF = 2 };

// The instances of the bf16 kernel. SERVED is rdb_wg_kernel (and the only
// instance of the int8 kernels); the others are rdb_wg_ablate_kernel<V>, the
// ports of the TPU kernel's staging knobs (s2sr_tpu/ops/pallas/
// fused_rdb_v4.py), reached only through s2sr_rdb_ablate_forward and never
// served. They time where the served kernel's time goes; each issues every
// ldmatrix and every wgmma of the served kernel:
// - NO_FILL (ablate="no_fill", fused_rdb_v4.py:188): stages 1-4 skip their
//   epilogue (bias, LeakyReLU, masking and the st.shared of x1..x4). Later
//   stages read whatever shared memory holds: the output has no defined
//   value, on purpose. The dropped sums are kept alive by wg_keep.
// - NO_ACC (ablate="no_acc", :211): the first k-step of each source issues
//   its wgmmas with scale-d 0 (D = A B), which zeroes the accumulators, so
//   stage S keeps only the product of source S-1 (x1 from x, x(k+1) from xk,
//   x5 from x4): ops/rdb.py::rdb_no_acc_reference. ptxas reads through an
//   empty asm: with scale-d a constant 0 it deleted the x products that
//   only fed it (52 ldmatrix, by the SASS count). So scale-d also ors in
//   Ring::keep, which is 1 only if the launch passes a sink (never).
// - SERIAL_B (prefetch=False, :113): the producer copies a slab only when
//   the consumers reach it (they arrive on the slot's empty barrier once
//   they have issued their last wgmma on the slab before), so every bulk
//   copy's latency is exposed instead of hidden behind the products. The
//   TPU knob serialises the input DMA; here the ring is the only copy that
//   overlaps the products. Same slabs in the same order: bit-equal to the
//   served kernel.
// The TPU kernel's fourth knob, stage_taps=9 (9-tap staging of the growth
// convs, K = 288), has no instance: x and x1..x4 take 200,704 B of the
// block's 232,448 B of shared memory, and one 9-tap copy of x1 for stage 2
// takes 22 * 22 * 288 * 2 = 278,784 B (bench/rdb_ladder.py says so).
enum Variant : int { SERVED = 0, NO_FILL = 1, NO_ACC = 2, SERIAL_B = 3 };

template <int K>
__host__ __device__ constexpr int nbuf() { return K == KBF ? NBUF_BF16 : NBUF; }

// 64-row M tiles over stage s's region, and the tiles each warpgroup runs
__host__ __device__ constexpr int wg_tiles(int s) {
  return (tc_side(s) * tc_side(s) + 63) / 64;
}
__host__ __device__ constexpr int wg_mt(int s) { return (wg_tiles(s) + WGS - 1) / WGS; }

// k-steps (32 bytes of K in a row of B: 32 s8 or 16 bf16 values) of source j:
// two a tap for x (64 channels in s8) and for bf16 x1..x4, four a tap for
// rdb_wg's bf16 x, one a tap for rdb_w8a8's s8 x1..x4
template <int K>
__host__ __device__ constexpr int src_steps(int j) {
  return j == 0 ? (K == KBF ? 36 : 18) : (K == KW8 ? 9 : 18);
}

// A stage's parts, each a run of k-steps from one packed stream: rdb_i8's
// part 0 is x (s8, stream wq) and part 1 x1..x_{s-1} (bf16, stream wf; stage
// 1 has none); rdb_w8a8's and rdb_wg's one part is x, x1..x_{s-1} (stream wq:
// s8, or bf16)
template <int K>
__host__ __device__ constexpr int n_parts(int s) { return K != KI8 || s == 1 ? 1 : 2; }
template <int K>
__host__ __device__ constexpr int part_steps(int s, int part) {
  int n = 0;
  for (int j = 0; j < s; ++j)
    if (K != KI8 || (part == 0) == (j == 0)) n += src_steps<K>(j);
  return n;
}
__host__ __device__ constexpr int n_slabs(int steps) { return (steps + KQ - 1) / KQ; }
// global index of part p of stage s's first slab; slab0(6, 0) counts them all
template <int K>
__host__ __device__ constexpr int slab0(int s, int p) {
  int n = 0;
  for (int k = 1; k < s; ++k)
    for (int q = 0; q < n_parts<K>(k); ++q) n += n_slabs(part_steps<K>(k, q));
  for (int q = 0; q < p; ++q) n += n_slabs(part_steps<K>(s, q));
  return n;
}
template <int K>
__host__ __device__ constexpr int total_slabs() { return slab0<K>(6, 0); }

// byte offset of source buffer j after the ring: rdb_i8 holds x in int8 (4
// chunks a pixel) and x1..x4 in bf16 (4 chunks), rdb_w8a8 all in int8 (x 4
// chunks, x1..x4 2), rdb_wg all in bf16 (x 8 chunks, x1..x4 4); every offset
// a multiple of 128 bytes
__host__ __device__ constexpr int w8_off(int j) {
  int off = 0;
  for (int k = 0; k < j; ++k) off += tc_side(k) * tc_side(k) * src_chans(k);
  return off;
}
template <int K>
__host__ __device__ constexpr int wg_src_off(int j) {
  return K == KW8 ? w8_off(j) : tc_off(j, K == KI8);
}
// [up to 1024 bytes to align the ring][ring][sources][2 nbuf mbarriers]
template <int K>
constexpr size_t wg_smem_bytes() {
  return 1024 + nbuf<K>() * SLOT + wg_src_off<K>(5) + 2 * nbuf<K>() * 8;
}
static_assert(wg_smem_bytes<KI8>() <= 232448 && wg_smem_bytes<KW8>() <= 232448 &&
              wg_smem_bytes<KBF>() <= 232448, "shared memory over the block limit");
static_assert(wg_smem_bytes<KBF>() == 226352 && wg_src_off<KBF>(5) == 200704,
              "rdb_wg's shared memory as its note counts it");

// Byte offset of 16-byte chunk c of pixel p in a resident source of CQ chunks
// a pixel (8: 128 bytes, 4: 64 bytes, 2: 32 bytes): the 8 / CQ pixels of a
// 128-byte line side by side, chunk c of pixel p at bank group
// (p + 8 / CQ * c) % 8. The 8 rows of an ldmatrix phase, 8 consecutive
// pixels at one chunk, then hit 8 bank groups from any first pixel; the XOR
// swizzle of rdb_tc_kernel (swz) does so only from an even one where a line
// holds two pixels. Over the int8 kernels' tap shifts, by count, 48-51% of
// the phases take two wavefronts with swz and 12-13% (those that cross a
// region row) with rot (tests/test_torch_int8.py counts them); over rdb_wg's,
// whose x fills a line a pixel (CQ 8), 27.1% with swz and 12.2% with rot
// (tests/test_torch_rdb_wg.py).
template <int CQ>
__device__ __forceinline__ uint32_t rot(uint32_t p, uint32_t c) {
  return (p * CQ / 8) * 128 + ((p + 8 / CQ * c) & 7) * 16;
}

// first of source j's factors in rdb_w8a8's deq
__host__ __device__ constexpr int w8_deq_off(int j) {
  int off = 0;
  for (int k = 0; k < j; ++k) off += NF + (4 - k) * G;
  return off;
}

// wgmma.mma_async, A from registers, B by descriptor: d += A B (scale-d 1;
// sums start from zeroed registers), or d = A B where a bf16 product's sd is
// 0 (the ablation NO_ACC). m64nNk32 s8 x s8 into int32 (N / 2 a thread),
// m64nNk16 bf16 into float32.
__device__ __forceinline__ void wg_s8_32(int* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_s8_64(int* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_bf16_32(float* d, const uint32_t (&a)[4], uint64_t b,
                                           int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
}

__device__ __forceinline__ void wg_bf16_64(float* d, const uint32_t (&a)[4], uint64_t b,
                                           int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sd));
}

template <int N>
__device__ __forceinline__ void wg_mma(int* d, const uint32_t (&a)[4], uint64_t b,
                                       int = 1) {
  if constexpr (N == 32) wg_s8_32(d, a, b);
  else wg_s8_64(d, a, b);
}
template <int N>
__device__ __forceinline__ void wg_mma(float* d, const uint32_t (&a)[4], uint64_t b,
                                       int sd = 1) {
  if constexpr (N == 32) wg_bf16_32(d, a, b, sd);
  else wg_bf16_64(d, a, b, sd);
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
// Orders the accumulators after a wgmma_wait for the compiler, which sees no
// register operand on the wait (CUTLASS's warpgroup_fence_operand).
template <int MT, int NA>
__device__ __forceinline__ void fence_acc(int (&d)[MT][NA]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NA; ++i) asm volatile("" : "+r"(d[m][i])::"memory");
}
template <int MT, int NA>
__device__ __forceinline__ void fence_acc(float (&d)[MT][NA]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[m][i])::"memory");
}

// Descriptor of a K-major, 128-byte-swizzled B slab at shared address addr:
// 8-row groups 1024 bytes apart (SBO 64), the leading offset unused by this
// layout (1), layout type 1 (SWIZZLE_128B). A k-step's start lies (k % 4) * 32
// bytes into its slab's 1024-aligned rows, so the base offset stays 0.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

// Waits for the phase of parity `parity` of the mbarrier at `bar`, polling
// inside one asm block, so that the consumers' wgmma pipeline holds no branch
// the compiler sees. A wait of 2^33 clocks (seconds) traps: a fault in the
// ring's bookkeeping ends the launch with an error instead of hanging.
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

// The B ring: nbuf<K>() slots of SLOT bytes from 1024-aligned `slots`, a
// `full` and an `empty` mbarrier a slot; wq and wf the packed streams (wq
// holds every stage's part 0: rdb_i8's s8 slabs of x, rdb_w8a8's s8 slabs,
// rdb_wg's bf16 slabs; wf rdb_i8's bf16 slabs of x1..x4).
struct Ring {
  uint32_t slots, full, empty;
  const unsigned char* wq;
  const unsigned char* wf;
  int keep;   // 1 if the launch passed a sink (wg_keep's; never): NO_ACC's
};

// The producer: slab g into its slot, one bulk copy from its stream (its
// place found by walking the parts in order), completing on the slot's full
// barrier.
template <int K>
__device__ __forceinline__ void issue_slab(const Ring& r, int g) {
  const unsigned char* src = nullptr;
  uint32_t bytes = 0;
  size_t off[2] = {0, 0};
  int h = g;
#pragma unroll
  for (int s = 1; s <= 5; ++s)
#pragma unroll
    for (int p = 0; p < n_parts<K>(s); ++p) {
      const int n = n_slabs(part_steps<K>(s, p));
      const uint32_t qb = stage_cout(s) * 128;
      if (h >= 0 && h < n) {
        src = (p ? r.wf : r.wq) + off[p] + (size_t)h * qb;
        bytes = qb;
      }
      h -= n;
      off[p] += (size_t)n * qb;
    }
  const uint32_t slot = (uint32_t)g % nbuf<K>();
  const uint32_t bar = r.full + 8 * slot;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               ::"r"(r.slots + slot * SLOT), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <int NB>
__device__ __forceinline__ void ring_wait(const Ring& r, int g) {
  mbar_wait(r.full + 8 * (g % NB), (uint32_t)(g / NB) & 1);
}

// This thread's wgmmas on slab g have completed: it arrives on the slot's
// empty barrier (all 256 consumer threads arrive, so no branch). Under
// SERIAL_B the same arrival, made as the consumers reach slab g, asks for it.
template <int NB>
__device__ __forceinline__ void ring_release(const Ring& r, int g) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(r.empty + 8 * (g % NB)) : "memory");
}

// The producer warp's lane 0: every slab in order, each into its slot once
// the consumers have released the slab nbuf before it (SERIAL_B: once they
// have asked for it).
template <int K, int V>
__device__ __forceinline__ void ring_produce(const Ring& r) {
  constexpr int NB = nbuf<K>();
  for (int g = 0; g < total_slabs<K>(); ++g) {
    if constexpr (V == SERIAL_B)
      mbar_wait(r.empty + 8 * (g % NB), (uint32_t)(g / NB) & 1);
    else if (g >= NB)
      mbar_wait(r.empty + 8 * (g % NB), (uint32_t)(g / NB - 1) & 1);
    issue_slab<K>(r, g);
  }
}

// The consumers' barrier between stages (named barrier 1: the producer warp
// does not take part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TC_WARPS * 32) : "memory");
}

// Where a k-step's A lies: its source's buffer, the source's region side,
// the stage region's offset in it, k-steps a tap.
struct Src {
  uint32_t base;
  int rj, d, spt;
};

// One k-step of the pipeline: index k of the run (src(k, kk) gives its
// source and sets kk, its index in that source), t0 + k of its part, whose
// slabs start at global index s0. ldmatrix of the M tiles' A, one fence, one
// wgmma a tile, one commit; then wait_group 1, so that a step's products run
// while the next step's A loads. The step before has then completed: a slab
// whose last k-step it was is released. CQ: 16-byte chunks a pixel of the
// run's sources; NB: slots of the ring; V: the instance (enum Variant); py,
// px: this lane's ldmatrix pixel in each M tile.
template <int CQ, int NB, int V, typename T, int MT, int NA, typename F>
__device__ __forceinline__ void wg_step(T (&acc)[MT][NA], uint32_t (&a)[MT][4],
                                        const Ring& ring, const int (&py)[MT],
                                        const int (&px)[MT], int k, int t0, int s0,
                                        F src) {
  const int tt = t0 + k;
  const int g = s0 + tt / KQ;
  if (tt % KQ == 0) {
    if constexpr (V == SERIAL_B) ring_release<NB>(ring, g);    // asks for slab g
    ring_wait<NB>(ring, g);
  }
  int kk;
  const Src sr = src(k, kk);
  const int tap = kk / sr.spt, cc = kk % sr.spt;
  const int oy = sr.d + tap / 3, ox = sr.d + tap % 3;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const uint32_t p = (uint32_t)((py[m] + oy) * sr.rj + px[m] + ox);
    tc_ldmatrix(a[m], sr.base + rot<CQ>(p, 2 * cc + (lane >> 4)));
  }
  // every input register of the step's wgmmas (A, B's descriptor, the
  // accumulators) defined before the fence: an instruction defining one
  // between the fence and the wgmmas serialises them (ptxas C7513)
  uint64_t desc = b_desc(ring.slots + (uint32_t)(g % NB) * SLOT + (tt % KQ) * 32);
  asm volatile("" : "+l"(desc)::"memory");
  // NO_ACC: a source's first k-step overwrites the sums (scale-d 0; keep
  // is 0 on every launch, which ptxas cannot know)
  int sd = 1;
  if constexpr (V == NO_ACC) sd = (kk != 0) | ring.keep;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int m = 0; m < MT; ++m) wg_mma<2 * NA>(acc[m], a[m], desc, sd);
  wgmma_commit();
  wgmma_wait<1>();
  if constexpr (V != SERIAL_B)
    if (tt % KQ == 0 && tt > 0) ring_release<NB>(ring, g - 1);
}

// The N k-steps (N >= 3) of a run from part index t0, whose slabs start at
// global index s0 (src as wg_step's), on two register sets of A in turn: a
// prologue of two steps (three if N is odd), then a runtime loop over pairs.
// Nothing is in flight when it starts; the caller waits for all at its end
// and releases the part's last slab. ptxas keeps consecutive steps' wgmmas
// in flight together only in this shape: a loop entered with accumulators
// that no wgmma has written yet (C7515), a third register set or a step
// after the loop (C7513) serialise them. (Two k-steps a fence measured no
// faster, and rdb_w8a8 then spills.)
template <int N, int CQ, int NB, int V, typename T, int MT, int NA, typename F>
__device__ __forceinline__ void wg_run(T (&acc)[MT][NA], const Ring& ring, int t0, int s0,
                                       const int (&py)[MT], const int (&px)[MT], F src) {
  static_assert(N >= 3, "a run of at least three k-steps");
  uint32_t a0[MT][4], a1[MT][4];
  wg_step<CQ, NB, V>(acc, a0, ring, py, px, 0, t0, s0, src);
  wg_step<CQ, NB, V>(acc, a1, ring, py, px, 1, t0, s0, src);
  if constexpr (N % 2 == 1) wg_step<CQ, NB, V>(acc, a0, ring, py, px, 2, t0, s0, src);
  // then the pairs: (a0, a1) after two steps, (a1, a0) after three
  uint32_t (&b0)[MT][4] = N % 2 == 1 ? a1 : a0;
  uint32_t (&b1)[MT][4] = N % 2 == 1 ? a0 : a1;
#pragma unroll 1
  for (int k = N % 2 == 1 ? 3 : 2; k < N; k += 2) {
    wg_step<CQ, NB, V>(acc, b0, ring, py, px, k, t0, s0, src);
    wg_step<CQ, NB, V>(acc, b1, ring, py, px, k + 1, t0, s0, src);
  }
}

template <typename T, int MT, int NA>
__device__ __forceinline__ void zero_acc(T (&d)[MT][NA]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NA; ++i) d[m][i] = 0;
}

// NO_FILL's keep-alive for the sums its stages 1-4 drop: stored under a
// guard that is never true (sink is null on every launch, which ptxas
// cannot know), so ptxas keeps the wgmmas that make them (it deletes an
// unread mma.sync even under asm volatile). The stores never run; each
// stage has its own addresses.
template <int MT, int NA>
__device__ __forceinline__ void wg_keep(float* sink, const float (&acc)[MT][NA], int slot) {
  if (sink) {
    constexpr int T = TC_WARPS * 32;
    float* s = sink + (size_t)slot * 128 * T + threadIdx.x;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NA; ++i) s[(m * NA + i) * T] = acc[m][i];
  }
}

// rdb_w8a8's sources J.. S-1 of stage S, each an s8 run from zero, its sums
// dequantized by its own factors at the stage's columns and added to acc
// before the next starts: a product and then a sum, each rounded once, as
// the plain version in float32.
template <int S, int J, int MT, int NA>
__device__ __forceinline__ void w8_sources(float (&acc)[MT][NA], int (&iacc)[MT][NA],
                                           const Ring& ring, uint32_t sbase,
                                           const float* __restrict__ deq,
                                           const int (&py)[MT], const int (&px)[MT]) {
  if constexpr (J < S) {
    constexpr int NK = src_steps<KW8>(J);
    constexpr int T0 = J == 0 ? 0 : 18 + 9 * (J - 1);
    const Src src = {sbase + wg_src_off<KW8>(J), tc_side(J), S - 1 - J, NK / 9};
    zero_acc(iacc);
    wg_run<NK, J == 0 ? 4 : 2, NBUF, SERVED>(iacc, ring, T0, slab0<KW8>(S, 0), py, px,
                                            [&](int k, int& kk) {
      kk = k;
      return src;
    });
    wgmma_wait<0>();
    fence_acc(iacc);
    const int t = threadIdx.x & 3;
    const float* dq = deq + w8_deq_off(J) + i8_col(S);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float d = __ldg(dq + 8 * (i / 4) + 2 * t + (i & 1));
#pragma unroll
      for (int m = 0; m < MT; ++m)
        acc[m][i] = __fadd_rn(acc[m][i], __fmul_rn(__int2float_rn(iacc[m][i]), d));
    }
    w8_sources<S, J + 1>(acc, iacc, ring, sbase, deq, py, px);
  }
}

// One conv stage S (1..5) of kernel K (enum Kind), instance V (enum Variant:
// SERVED but for rdb_wg's ablations). deq: rdb_i8's 192 factors of the x
// conv, or rdb_w8a8's 640 of x, x1..x4; qm: rdb_w8a8's five multipliers;
// sink: wg_keep's.
template <int S, int K, int V>
__device__ __forceinline__ void wg_stage(const Ring& ring, uint32_t sbase,
                                         const float* __restrict__ deq,
                                         const float* __restrict__ qm,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ mask,
                                         const __nv_bfloat16* __restrict__ x,
                                         __nv_bfloat16* __restrict__ out, float* sink,
                                         int b, int H, int W, int oy0, int ox0) {
  constexpr int NB = nbuf<K>();
  constexpr int RS = tc_side(S);
  constexpr int NPIX = RS * RS;
  constexpr int MT = wg_mt(S);
  constexpr int COUT = stage_cout(S);
  constexpr int NA = COUT / 2;            // accumulators a thread a tile
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  int py[MT], px[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    int p = (wg + WGS * m) * 64 + warp * 16 + (lane & 15);
    p = p < NPIX ? p : NPIX - 1;
    py[m] = p / RS;
    px[m] = p % RS;
  }
  // accumulator (m, i = 4k + 2h + e) is tile pixel 16 warp + g + 8h at
  // channel 8k + 2t + e
  float acc[MT][NA];
  constexpr int S0 = slab0<K>(S, 0);
  if constexpr (K == KI8) {
    // part 0: x's rows in s8, dequantized by the x conv's stage columns
    int iacc[MT][NA];
    const Src xs = {sbase, tc_side(0), S - 1, 2};
    zero_acc(iacc);
    wg_run<18, 4, NB, V>(iacc, ring, 0, S0, py, px, [&](int k, int& kk) {
      kk = k;
      return xs;
    });
    wgmma_wait<0>();
    fence_acc(iacc);
    ring_release<NB>(ring, S0 + n_slabs(part_steps<K>(S, 0)) - 1);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float dq = __ldg(deq + i8_col(S) + 8 * (i / 4) + 2 * t + (i & 1));
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m][i] = __fmul_rn(__int2float_rn(iacc[m][i]), dq);
    }
    // part 1: x1..x_{S-1} in bf16, added in order (source j's 18 k-steps
    // from part index 18 (j - 1))
    if constexpr (S > 1) {
      wg_run<18 * (S - 1), 4, NB, V>(acc, ring, 0, slab0<K>(S, 1), py, px,
                                     [&](int k, int& kk) {
        const int j = 1 + k / 18;
        kk = k % 18;
        const uint32_t off = j == 1   ? wg_src_off<K>(1)
                             : j == 2 ? wg_src_off<K>(2)
                             : j == 3 ? wg_src_off<K>(3)
                                      : wg_src_off<K>(4);
        return Src{sbase + off, tc_side(j), S - 1 - j, 2};
      });
      wgmma_wait<0>();
      fence_acc(acc);
      ring_release<NB>(ring, slab0<K>(S, 1) + n_slabs(part_steps<K>(S, 1)) - 1);
    }
  } else if constexpr (K == KW8) {
    int iacc[MT][NA];
    zero_acc(acc);
    w8_sources<S, 0>(acc, iacc, ring, sbase, deq, py, px);
    ring_release<NB>(ring, S0 + n_slabs(part_steps<K>(S, 0)) - 1);
  } else {
    // rdb_wg: one part, bf16 products into float32 from zeroed registers:
    // x's 36 k-steps (8-chunk pixels, four a tap), then x1..x_{S-1}'s 18
    // each (4-chunk pixels) from part index 36, x's last slab released by
    // the second run's first step
    zero_acc(acc);
    const Src xs = {sbase, tc_side(0), S - 1, 4};
    wg_run<36, 8, NB, V>(acc, ring, 0, S0, py, px, [&](int k, int& kk) {
      kk = k;
      return xs;
    });
    wgmma_wait<0>();
    fence_acc(acc);
    if constexpr (S > 1) {
      wg_run<18 * (S - 1), 4, NB, V>(acc, ring, 36, S0, py, px, [&](int k, int& kk) {
        const int j = 1 + k / 18;
        kk = k % 18;
        const uint32_t off = j == 1   ? wg_src_off<K>(1)
                             : j == 2 ? wg_src_off<K>(2)
                             : j == 3 ? wg_src_off<K>(3)
                                      : wg_src_off<K>(4);
        return Src{sbase + off, tc_side(j), S - 1 - j, 2};
      });
      wgmma_wait<0>();
      fence_acc(acc);
    }
    if constexpr (V != SERIAL_B)
      ring_release<NB>(ring, S0 + n_slabs(part_steps<K>(S, 0)) - 1);
  }

  // NO_FILL: stages 1-4 store nothing (their sums kept alive for ptxas)
  if constexpr (V == NO_FILL && S < 5) {
    wg_keep(sink, acc, S);
    return;
  }

  // epilogue. Every global value it reads (biases, rdb_w8a8's multiplier,
  // the mask, x's residual) is loaded into registers before the first store:
  // a load behind a shared-memory store waits for it, one round trip each.
  float bv[COUT / 8][2];
#pragma unroll
  for (int k = 0; k < COUT / 8; ++k) {
    bv[k][0] = __ldg(bias + (S - 1) * G + 8 * k + 2 * t);
    bv[k][1] = __ldg(bias + (S - 1) * G + 8 * k + 2 * t + 1);
  }
  const size_t img_off = (size_t)b * H * W;
  // this thread's rows: tile pixel p (16 warp + g + 8h of tile w + 2m), its
  // place in the image, and whether it is there
  int gy[MT][2], gx[MT][2];
  float mk[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (wg + WGS * m) * 64 + warp * 16 + g + 8 * h;
      constexpr int HS = S < 5 ? HALO - S : 0;
      gy[m][h] = p < NPIX ? oy0 - HS + p / RS : -1;
      gx[m][h] = ox0 - HS + p % RS;
      const bool in = gy[m][h] >= 0 && gy[m][h] < H && gx[m][h] >= 0 && gx[m][h] < W;
      mk[m][h] = !in ? 0.f : (mask ? mask[img_off + (size_t)gy[m][h] * W + gx[m][h]] : 1.f);
    }
  if constexpr (S < 5) {
    const float qs = K == KW8 ? __ldg(qm + S) : 0.f;
    const uint32_t dst = sbase + wg_src_off<K>(S);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wg + WGS * m) * 64 + warp * 16 + g + 8 * h;
        if (p >= NPIX) continue;
        // outside the image x_S is 0 (the SAME padding of the next convs)
        const bool inside = gy[m][h] >= 0 && gy[m][h] < H && gx[m][h] >= 0 && gx[m][h] < W;
#pragma unroll
        for (int k = 0; k < COUT / 8; ++k) {
          const int co = 8 * k + 2 * t;
          const float a0 = acc[m][4 * k + 2 * h], a1 = acc[m][4 * k + 2 * h + 1];
          if constexpr (K == KW8) {
            // x_S in int8: channels co, co + 1 are bytes co % 16, co % 16 + 1
            // of chunk co / 16 of a 2-chunk pixel; quant(0) = 0
            float v0 = __fadd_rn(a0, bv[k][0]);
            float v1 = __fadd_rn(a1, bv[k][1]);
            v0 = __fmul_rn(v0 >= 0.f ? v0 : __fmul_rn(0.2f, v0), mk[m][h]);
            v1 = __fmul_rn(v1 >= 0.f ? v1 : __fmul_rn(0.2f, v1), mk[m][h]);
            const uint32_t pr = inside ? (quant1(v0, qs) | quant1(v1, qs) << 8) : 0u;
            asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst + rot<2>(p, co >> 4) + (co & 15)),
                         "h"((unsigned short)pr) : "memory");
          } else {
            // x_S in bf16: channels 8k.. are chunk k of a 4-chunk pixel
            float v0 = a0 + bv[k][0];
            float v1 = a1 + bv[k][1];
            v0 = (v0 >= 0.f ? v0 : 0.2f * v0) * mk[m][h];
            v1 = (v1 >= 0.f ? v1 : 0.2f * v1) * mk[m][h];
            if (!inside) v0 = v1 = 0.f;
            const __nv_bfloat162 pr = __floats2bfloat162_rn(v0, v1);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + rot<4>(p, k) + 4 * t),
                         "r"(*reinterpret_cast<const uint32_t*>(&pr)) : "memory");
          }
        }
      }
  } else {
    // out = m(0.2 (x5 + b5) + x), every value of x read before any store:
    // rdb_wg from its resident bf16 copy (region 0 has a 5-pixel halo, 8
    // chunks a pixel), the int8 kernels, which hold x only in int8, from
    // device memory
    uint32_t xin[MT][2][COUT / 8];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool in = gy[m][h] >= 0 && gy[m][h] < H && gx[m][h] < W;
        if constexpr (K == KBF) {
          const int p = (wg + WGS * m) * 64 + warp * 16 + g + 8 * h;
          const int xp = in ? (p / RS + HALO) * tc_side(0) + p % RS + HALO : 0;
#pragma unroll
          for (int k = 0; k < COUT / 8; ++k) {
            asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(xin[m][h][k])
                         : "r"(sbase + rot<8>(xp, k) + 4 * t) : "memory");
            if (!in) xin[m][h][k] = 0u;
          }
        } else {
          const size_t pix = img_off + (size_t)(in ? gy[m][h] : 0) * W + (in ? gx[m][h] : 0);
#pragma unroll
          for (int k = 0; k < COUT / 8; ++k)
            xin[m][h][k] = in ? __ldg(reinterpret_cast<const unsigned int*>(
                                    x + pix * NF + 8 * k + 2 * t))
                              : 0u;
        }
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (gy[m][h] < 0 || gy[m][h] >= H || gx[m][h] >= W) continue;
        const size_t pix = img_off + (size_t)gy[m][h] * W + gx[m][h];
#pragma unroll
        for (int k = 0; k < COUT / 8; ++k) {
          const int co = 8 * k + 2 * t;
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xin[m][h][k]));
          const float v0 = (acc[m][4 * k + 2 * h] + bv[k][0]) * 0.2f + xf.x;
          const float v1 = (acc[m][4 * k + 2 * h + 1] + bv[k][1]) * 0.2f + xf.y;
          const __nv_bfloat162 pr = __floats2bfloat162_rn(v0 * mk[m][h], v1 * mk[m][h]);
          *reinterpret_cast<__nv_bfloat162*>(out + pix * NF + co) = pr;
        }
      }
  }
}

// The consumers' part of the body: the input tile with its 5-pixel halo,
// then the five stages. rdb_wg copies it in bf16 (16-byte cp.async copies
// into chunk c of 8-chunk pixel p, zero-filled outside the image: a source
// size of 0 reads nothing); the int8 kernels quantize it on the way in (one
// 16-byte load of 8 channels becomes 8 bytes of chunk c / 2 of a 4-chunk
// pixel; zero outside the image, quant(0) = 0).
template <int K, int V>
__device__ __forceinline__ void wg_consume(const Ring& ring, uint32_t sbase,
                                           const __nv_bfloat16* __restrict__ x,
                                           const float* __restrict__ mask,
                                           __nv_bfloat16* __restrict__ out,
                                           const float* __restrict__ deq,
                                           const float* __restrict__ qm, float qm0,
                                           const float* __restrict__ bias, float* sink,
                                           int H, int W) {
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TC_TILE, ox0 = blockIdx.x * TC_TILE;
  const size_t img_off = (size_t)b * H * W;
  if constexpr (K == KBF) {
    constexpr int R = tc_side(0);
    for (int i = threadIdx.x; i < R * R * 8; i += TC_WARPS * 32) {
      const int p = i >> 3, c = i & 7;
      const int gy = oy0 - HALO + p / R, gx = ox0 - HALO + p % R;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const __nv_bfloat16* src =
          in ? x + (img_off + (size_t)gy * W + gx) * NF + 8 * c : x;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(sbase + rot<8>(p, c)), "l"(src), "r"(in ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // eleven 16-byte loads in flight a thread before their stores (two
    // rounds for the 5,408 loads of the tile)
    constexpr int R = tc_side(0), N = R * R * 8, T = TC_WARPS * 32, U = 11;
    for (int i0 = threadIdx.x; i0 < N; i0 += U * T) {
      uint4 v[U];
      bool in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * T, p = i >> 3, c = i & 7;
        const int gy = oy0 - HALO + p / R, gx = ox0 - HALO + p % R;
        in[u] = i < N && gy >= 0 && gy < H && gx >= 0 && gx < W;
        if (in[u])
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              x + (img_off + (size_t)gy * W + gx) * NF + 8 * c));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * T, p = i >> 3, c = i & 7;
        if (i >= N) break;
        const uint32_t lo = in[u] ? quant4(v[u].x, v[u].y, qm0) : 0u;
        const uint32_t hi = in[u] ? quant4(v[u].z, v[u].w, qm0) : 0u;
        asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n"
                     ::"r"(sbase + rot<4>(p, c >> 1) + 8 * (c & 1)), "r"(lo), "r"(hi)
                     : "memory");
      }
    }
  }
  consumer_sync();
  wg_stage<1, K, V>(ring, sbase, deq, qm, bias, mask, x, out, sink, b, H, W, oy0, ox0);
  consumer_sync();
  wg_stage<2, K, V>(ring, sbase, deq, qm, bias, mask, x, out, sink, b, H, W, oy0, ox0);
  consumer_sync();
  wg_stage<3, K, V>(ring, sbase, deq, qm, bias, mask, x, out, sink, b, H, W, oy0, ox0);
  consumer_sync();
  wg_stage<4, K, V>(ring, sbase, deq, qm, bias, mask, x, out, sink, b, H, W, oy0, ox0);
  consumer_sync();
  wg_stage<5, K, V>(ring, sbase, deq, qm, bias, mask, x, out, sink, b, H, W, oy0, ox0);
}

// The body of the three kernels: the ring and its barriers, then the
// producer warp and the consumers.
template <int K, int V>
__device__ __forceinline__ void wg_body(const __nv_bfloat16* __restrict__ x,
                                        const float* __restrict__ mask,
                                        __nv_bfloat16* __restrict__ out,
                                        const unsigned char* wq, const unsigned char* wf,
                                        const float* __restrict__ deq,
                                        const float* __restrict__ qm, float qm0,
                                        const float* __restrict__ bias, float* sink,
                                        int H, int W) {
  constexpr int NB = nbuf<K>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  Ring ring;
  ring.slots = (raw + 1023) & ~1023u;
  const uint32_t sbase = ring.slots + NB * SLOT;
  ring.full = sbase + wg_src_off<K>(5);
  ring.empty = ring.full + 8 * NB;
  ring.wq = wq;
  ring.wf = wf;
  ring.keep = sink != nullptr;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NB; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(ring.full + 8 * i) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   ::"r"(ring.empty + 8 * i), "r"(TC_WARPS * 32) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the roles, read warp-uniform (as CUTLASS reads them), in one if-else
  // that never rejoins, so that setmaxnreg holds: warpgroups 0 and 1
  // consume with 240 registers a thread, warpgroup 2 gives its registers
  // down to 24 and its first thread produces. The launch's 384 threads
  // start at 168 a thread, too few for rdb_w8a8's int32 and float32
  // accumulators and two sets of A (ptxas serialises the wgmmas: C7512).
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == WGS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == WGS * 128) ring_produce<K, V>(ring);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    wg_consume<K, V>(ring, sbase, x, mask, out, deq, qm, qm0, bias, sink, H, W);
  }
}

// The main path's bf16 RDB: wb the bf16 slabs of the five convs, stage by
// stage (ops/rdb.py::pack_rdb_wg).
__global__ void __launch_bounds__(WG_THREADS, 1)
rdb_wg_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mask,
              __nv_bfloat16* __restrict__ out, const unsigned char* __restrict__ wb,
              const float* __restrict__ bias, int H, int W) {
  wg_body<KBF, SERVED>(x, mask, out, wb, nullptr, nullptr, nullptr, 0.f, bias, nullptr,
                       H, W);
}

// The time-attribution instances of rdb_wg_kernel (enum Variant): never
// served. sink is wg_keep's, null on every launch.
template <int V>
__global__ void __launch_bounds__(WG_THREADS, 1)
rdb_wg_ablate_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, const unsigned char* __restrict__ wb,
                     const float* __restrict__ bias, float* sink, int H, int W) {
  wg_body<KBF, V>(x, mask, out, wb, nullptr, nullptr, nullptr, 0.f, bias, sink, H, W);
}

// The bf16 RDB with its x conv in int8: wq the x conv's s8 slabs, wf x1..x4's
// bf16 slabs (ops/rdb.py::pack_rdb_i8_fragments, pack_rdb_i8_bf16), deq
// the x conv's 192 dequantization factors in packed column order, qm x's
// quantization multiplier.
__global__ void __launch_bounds__(WG_THREADS, 1)
rdb_i8_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mask,
              __nv_bfloat16* __restrict__ out, const unsigned char* __restrict__ wf,
              const unsigned char* __restrict__ wq, const float* __restrict__ deq,
              const float* __restrict__ bias, float qm, int H, int W) {
  wg_body<KI8, SERVED>(x, mask, out, wq, wf, deq, nullptr, qm, bias, nullptr, H, W);
}

// The full-W8A8 RDB: wq the s8 slabs of the five packed kernels, stage by
// stage (ops/rdb.py::pack_rdb_w8a8), deq the 640 factors of x, x1..x4
// concatenated, qm their five quantization multipliers.
__global__ void __launch_bounds__(WG_THREADS, 1)
rdb_w8a8_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mask,
                __nv_bfloat16* __restrict__ out, const unsigned char* __restrict__ wq,
                const float* __restrict__ deq, const float* __restrict__ qm,
                const float* __restrict__ bias, int H, int W) {
  wg_body<KW8, SERVED>(x, mask, out, wq, nullptr, deq, qm, __ldg(qm), bias, nullptr,
                       H, W);
}

dim3 tile_grid(int B, int H, int W) {
  return dim3((W + TC_TILE - 1) / TC_TILE, (H + TC_TILE - 1) / TC_TILE, B);
}

// rdb_wg_kernel (V SERVED) or its instance V
template <int V>
int launch_wg(const void* x, const void* mask, void* out, const void* wb,
              const void* bias, int B, int H, int W, cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<KBF>();
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* mk = static_cast<const float*>(mask);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const auto* wbb = static_cast<const unsigned char*>(wb);
  const auto* bb = static_cast<const float*>(bias);
  cudaError_t e;
  if constexpr (V == SERVED) {
    e = cudaFuncSetAttribute(rdb_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    rdb_wg_kernel<<<tile_grid(B, H, W), WG_THREADS, smem, stream>>>(xb, mk, ob, wbb, bb,
                                                                    H, W);
  } else {
    e = cudaFuncSetAttribute(rdb_wg_ablate_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    rdb_wg_ablate_kernel<V><<<tile_grid(B, H, W), WG_THREADS, smem, stream>>>(
        xb, mk, ob, wbb, bb, nullptr, H, W);
  }
  return (int)cudaGetLastError();
}

int launch_i8(const void* x, const void* mask, void* out, const void* wf,
              const void* wq, const void* deq, const void* bias, float qm,
              int B, int H, int W, cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<KI8>();
  const cudaError_t e = cudaFuncSetAttribute(
      rdb_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  rdb_i8_kernel<<<tile_grid(B, H, W), WG_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<const unsigned char*>(wf),
      static_cast<const unsigned char*>(wq), static_cast<const float*>(deq),
      static_cast<const float*>(bias), qm, H, W);
  return (int)cudaGetLastError();
}

int launch_w8a8(const void* x, const void* mask, void* out, const void* wq,
                const void* deq, const void* qm, const void* bias, int B, int H,
                int W, cudaStream_t stream) {
  constexpr size_t smem = wg_smem_bytes<KW8>();
  const cudaError_t e = cudaFuncSetAttribute(
      rdb_w8a8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  rdb_w8a8_kernel<<<tile_grid(B, H, W), WG_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<const unsigned char*>(wq),
      static_cast<const float*>(deq), static_cast<const float*>(qm),
      static_cast<const float*>(bias), H, W);
  return (int)cudaGetLastError();
}

// --- float32 on wgmma: rdb_f32_wg_kernel, split TF32 --------------------------
//
// The float32 block (precision "float32": _rdb_packed in float32, the
// function of fused_rdb_v4.py:234 rdb_pallas_v4) on the tensor cores. What
// bounds it on this card: as counted in chip_smoke.py, operations, 479,232
// FLOP a pixel at 67 TFLOP/s of FP32 FMA (7.98 ms at (16, 264, 264)). The
// tensor cores take float32 only as TF32 (10 stored mantissa bits), which
// alone keeps about three decimal digits. So each operand v is split into
// hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi) (CUTLASS's
// OpMultiplyAddFastF32, "3xTF32"), and every multiply-add is taken as three
// wgmma.m64nNk8.f32.tf32.tf32 products, in this order every k-step: lo_a
// hi_b, hi_a lo_b, hi_a hi_b (the small terms first); lo_a lo_b, under
// 2^-22 of the product, is dropped. The three go into float32 partial sums
// of their own, which are added to the running float32 sums, rounded, once
// they have completed (f32_step says why). At 495 TFLOP/s of TF32 the three
// products floor the kernel at 3.24 ms unpadded and 7.23 ms as executed
// (34.21 M multiply-adds a tile, 17,424 tiles; 6.73 ms at the 31.85 M of
// a design without stage 3's padded tile, below), against 21.5 ms for the
// CUDA-core design at full issue.
//
// The design is rdb_wg_kernel's with float32 where it holds bf16, at
// rdb_kernel<float>'s 8x8 tile, whose sources fill the same 172,032 bytes:
// - The sources x, x1..x4 resident in float32, pixel-major: x 16 chunks of
//   16 bytes a pixel, x1..x4 8, chunk c of pixel p at bank group
//   (p + c) % 8 (rot_f32), so that an ldmatrix phase of 8 consecutive
//   pixels hits 8 bank groups.
// - A from registers: ldmatrix.x4 of 32-bit elements (four 8-pixel x
//   4-channel matrices) returns wgmma's TF32 A fragment (a0 (g, t), a1
//   (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)); each thread splits it
//   into hi and lo in registers, and the three products read them from
//   there. A k-step is 8 channels of one tap: x's 72, x1..x4's 36 each.
// - B packed once a body by ops/rdb.py::pack_rdb_f32_wg: per 4 k-steps a
//   slab of N rows x 128 bytes (rdb_wg's K-major layout with the 128-byte
//   swizzle, 8 TF32 values a k-step) for hi and one for lo. The stream is a
//   run of 8 KB units: a stage 1-4 group's hi and lo slabs (32 rows) in one,
//   stage 5's hi (64 rows), then its lo, in two. A producer warpgroup's
//   first thread copies unit g into slot g % 7 of the ring by one
//   cp.async.bulk, completing on the slot's full mbarrier; all consumers
//   arrive on its empty mbarrier once their wgmmas on it have completed.
// - M tiles of 64 region pixels: 4, 4, 3, 2 and 1 over stages 1-4 and 5.
//   In stages 1-4 warpgroup w runs tiles w, w + 2 over all of Cout (N 32;
//   stage 3's fourth tile is all padding); stage 5 gives both warpgroups its
//   one tile over half of Cout (N 32 each, B from row 32 w). 34.21 M
//   multiply-adds a tile executed (31.85 M if stage 3 ran only its 3
//   tiles: each warpgroup all 3 at N 16, half of Cout, which was slower
//   on an H100: an N 16 wgmma is half the work for the same A and its
//   split).
// - A step is 2 k-steps (4 in stage 5) under one wait: a step of one
//   k-step (48 tensor clocks at N 32 a tile) is shorter than the step's
//   own wait, fold, loads and split (slower on an H100).
// - Per k-step at N 32 shared memory moves A once into registers (2 KB)
//   and B three times (hi twice, lo once: 3 KB), about 40 clocks of its
//   128 bytes a clock against 48 of the tensor cores; unlike the bf16
//   kernel's (24 against 16), the port does not bind first.
// Every output sums the same units in the same order with the same wgmma
// shape and product order wherever its pixel lies (tile, batch, image):
// the float32 serving contracts. Shared memory: 1,024 to align the ring,
// 7 x 8,192, the sources 172,032 and two mbarriers a slot: 230,512 of the
// block's 232,448 (ops/rdb.py::rdb_f32_wg_smem_plan). A 10x10 tile's
// sources alone would take 220,160, leaving one slot.

constexpr int F32_NBUF = 7;        // slots of the B ring
constexpr int F32_UNIT = 8192;     // bytes a slot: one unit of the stream

__host__ __device__ constexpr int f32_side(int j) { return TILE_F32 + 2 * (HALO - j); }
// byte offset of source j (0 = x, 1..4 = x1..x4) after the ring, float32
__host__ __device__ constexpr int f32_off(int j) {
  int off = 0;
  for (int k = 0; k < j; ++k) off += f32_side(k) * f32_side(k) * src_chans(k) * 4;
  return off;
}
// 64-row M tiles over stage s's region; a stage of one tile (stage 5)
// gives both warpgroups that tile over half of Cout (f32_split), the others
// give warpgroup w tiles w, w + 2 (stage 3's fourth all padding)
__host__ __device__ constexpr int f32_tiles(int s) {
  return (f32_side(s) * f32_side(s) + 63) / 64;
}
__host__ __device__ constexpr bool f32_split(int s) { return f32_tiles(s) < WGS; }
__host__ __device__ constexpr int f32_mt(int s) {
  return f32_split(s) ? f32_tiles(s) : (f32_tiles(s) + WGS - 1) / WGS;
}
__host__ __device__ constexpr int f32_nw(int s) {
  return f32_split(s) ? stage_cout(s) / WGS : stage_cout(s);
}
// k-steps (8 channels of one tap) of source j, and of stage s
__host__ __device__ constexpr int f32_src_steps(int j) { return j == 0 ? 72 : 36; }
__host__ __device__ constexpr int f32_steps(int s) {
  return f32_src_steps(0) + (s - 1) * f32_src_steps(1);
}
// units a group of KQ k-steps takes (hi and lo of 32 rows in one; of 64 in
// two), and the first unit of stage s; f32_unit0(6) counts them all
__host__ __device__ constexpr int f32_upg(int s) { return stage_cout(s) / G; }
__host__ __device__ constexpr int f32_unit0(int s) {
  int n = 0;
  for (int k = 1; k < s; ++k) n += f32_steps(k) / KQ * f32_upg(k);
  return n;
}
constexpr int F32_UNITS = f32_unit0(6);
// [up to 1024 bytes to align the ring][ring][sources][2 F32_NBUF mbarriers]
constexpr size_t f32_smem_bytes() {
  return 1024 + F32_NBUF * F32_UNIT + f32_off(5) + 2 * F32_NBUF * 8;
}
static_assert(f32_off(5) == 172032 && F32_UNITS == 234, "the float32 sources and stream");
static_assert(f32_smem_bytes() == 230512 && f32_smem_bytes() <= 232448,
              "rdb_f32_wg's shared memory as its note counts it");

// Byte offset of 16-byte chunk c of pixel p in a float32 source of CQ (8 or
// 16) chunks a pixel: CQ / 8 128-byte lines a pixel, chunk c at bank group
// (p + c) % 8.
template <int CQ>
__device__ __forceinline__ uint32_t rot_f32(uint32_t p, uint32_t c) {
  return (p * CQ + (c & ~7u)) * 16 + ((p + c) & 7) * 16;
}

// float32 -> TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away from
// zero; bit for bit on finite values): half of the 13 dropped bits' range
// added to the bit pattern, then those bits cleared. An add and a mask on
// the integer pipe, where the conversion issues at a quarter of the FP32
// rate: 8 a value quad would cost ~64 clocks a tile's k8 slice against
// the tensor cores' 48 (the conversion made the kernel slower on an
// H100).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// wgmma.mma_async, A (TF32) from registers, B (TF32) by descriptor:
// m64n16k8 and m64n32k8 into float32, d += A B, or with FIRST d = A B
// (scale-d 0), d then an output alone: no instruction but a wgmma defines
// a partial sum (ptxas serialises the wgmmas if one does: C7515)
#define S2SR_TF32_ASM(N, D)                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #D ", 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 "
template <bool FIRST>
__device__ __forceinline__ void wg_tf32_16(float* d, const uint32_t (&a)[4], uint64_t b) {
  if constexpr (FIRST)
    asm volatile(S2SR_TF32_ASM(16, 13)
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
                 : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
                   "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  else
    asm volatile(S2SR_TF32_ASM(16, 13)
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <bool FIRST>
__device__ __forceinline__ void wg_tf32_32(float* d, const uint32_t (&a)[4], uint64_t b) {
  if constexpr (FIRST)
    asm volatile(S2SR_TF32_ASM(32, 21)
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
                   "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
                   "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
                   "=f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  else
    asm volatile(S2SR_TF32_ASM(32, 21)
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef S2SR_TF32_ASM

template <int N, bool FIRST>
__device__ __forceinline__ void wg_tf32(float* d, const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) wg_tf32_16<FIRST>(d, a, b);
  else wg_tf32_32<FIRST>(d, a, b);
}

// The producer's thread: every unit in order, each into its slot once the
// consumers have released the unit F32_NBUF before it.
__device__ __forceinline__ void f32_produce(const Ring& r) {
  for (int g = 0; g < F32_UNITS; ++g) {
    const uint32_t slot = (uint32_t)g % F32_NBUF;
    if (g >= F32_NBUF) mbar_wait(r.empty + 8 * slot, (uint32_t)(g / F32_NBUF - 1) & 1);
    const uint32_t bar = r.full + 8 * slot;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"((uint32_t)F32_UNIT) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 ::"r"(r.slots + slot * F32_UNIT), "l"(r.wq + (size_t)g * F32_UNIT),
                 "r"((uint32_t)F32_UNIT), "r"(bar) : "memory");
  }
}

// acc += p, each sum rounded to nearest; p read after the wait that
// completed the wgmmas writing it
template <int MT, int NA>
__device__ __forceinline__ void f32_fold(float (&acc)[MT][NA], float (&p)[MT][NA]) {
  fence_acc(p);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[m][i] = __fadd_rn(acc[m][i], p[m][i]);
}

// k8 slices (8 channels of one tap) a step of stage S: two; four in stage 5,
// whose warpgroups run one M tile each (a step of one slice is 48 tensor
// clocks there, short of the step's own wait, fold, loads and split)
__host__ __device__ constexpr int f32_sl(int s) { return s == 5 ? 4 : 2; }

// One step of stage S (wg_step's pipeline), SL k8 slices of one tap: step
// k of the run (src(k SL, kk) as wg_step's, kk the source's k8 index),
// slices t0 + k SL.. of the stage. Its group's units waited for at the
// group's first step (a step never crosses a group); per slice, ldmatrix
// of the M tiles' A, split into hi and lo (ah, al: one of the run's two
// register sets); one fence, per tile and slice the three products into
// the step's partial sums pn (the first with scale-d 0), one commit; then
// wait_group 1, after which the step before has completed: unless this is
// the run's first step (FOLD false), its partials po are added to acc,
// rounded (__fadd_rn), and a group whose last step it was is released. The
// tensor cores truncate where they add a product sum to an accumulator;
// chained over a stage's 216 slices (648 sums) that loses more than the
// 1e-5 of the block's change float32 is held to (tests/
// test_torch_rdb_f32_wg.py emulates both), 6 or 12 sums a chain keep it
// near float32's. boff: byte offset of the warpgroup's first B row in a
// slab.
template <int S, int CQ, bool FOLD, int MT, int SL, int NA, typename F>
__device__ __forceinline__ void f32_step(float (&acc)[MT][NA], float (&pn)[MT][NA],
                                         float (&po)[MT][NA], uint32_t (&ah)[MT][SL][4],
                                         uint32_t (&al)[MT][SL][4], const Ring& ring,
                                         const int (&py)[MT], const int (&px)[MT],
                                         uint32_t boff, int k, int t0, F src) {
  constexpr int U = f32_upg(S);
  const int tt = t0 + k * SL, r = tt % KQ;
  const int g = f32_unit0(S) + tt / KQ * U;
  if (r == 0) {
    ring_wait<F32_NBUF>(ring, g);
    if constexpr (U == 2) ring_wait<F32_NBUF>(ring, g + 1);
  }
  int kk;
  const Src sr = src(k * SL, kk);
  const int tap = kk / sr.spt, cc = kk % sr.spt;
  const int oy = sr.d + tap / 3, ox = sr.d + tap % 3;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const uint32_t p = (uint32_t)((py[m] + oy) * sr.rj + px[m] + ox);
#pragma unroll
    for (int q = 0; q < SL; ++q) {
      uint32_t v[4];
      tc_ldmatrix(v, sr.base + rot_f32<CQ>(p, 2 * (cc + q) + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float f = __uint_as_float(v[i]);
        ah[m][q][i] = tf32_rna(f);
        al[m][q][i] = tf32_rna(__fsub_rn(f, __uint_as_float(ah[m][q][i])));
      }
    }
  }
  // hi at the group's unit; lo 4 KB into it (32 rows), or the next unit
  const uint32_t hi = ring.slots + (uint32_t)(g % F32_NBUF) * F32_UNIT + boff + r * 32;
  const uint32_t lo = U == 2 ? ring.slots + (uint32_t)((g + 1) % F32_NBUF) * F32_UNIT +
                                   boff + r * 32
                             : hi + F32_UNIT / 2;
  uint64_t dh[SL], dl[SL];
#pragma unroll
  for (int q = 0; q < SL; ++q) {
    dh[q] = b_desc(hi + q * 32);
    dl[q] = b_desc(lo + q * 32);
    asm volatile("" : "+l"(dh[q]), "+l"(dl[q])::"memory");
  }
  wgmma_fence();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    wg_tf32<2 * NA, true>(pn[m], al[m][0], dh[0]);
    wg_tf32<2 * NA, false>(pn[m], ah[m][0], dl[0]);
    wg_tf32<2 * NA, false>(pn[m], ah[m][0], dh[0]);
#pragma unroll
    for (int q = 1; q < SL; ++q) {
      wg_tf32<2 * NA, false>(pn[m], al[m][q], dh[q]);
      wg_tf32<2 * NA, false>(pn[m], ah[m][q], dl[q]);
      wg_tf32<2 * NA, false>(pn[m], ah[m][q], dh[q]);
    }
  }
  wgmma_commit();
  wgmma_wait<1>();
  if constexpr (FOLD) f32_fold(acc, po);
  if (r == 0 && tt > 0) {
    ring_release<F32_NBUF>(ring, g - U);
    if constexpr (U == 2) ring_release<F32_NBUF>(ring, g - 1);
  }
}

// The N steps (N even) of a run from stage slice t0 on two register sets of
// A and of partial sums in turn (wg_run's shape, which keeps ptxas from
// serialising the wgmmas): a prologue of two steps, then a runtime loop over
// pairs; at its end every step's partials are in acc, in step order.
template <int N, int CQ, int S, int MT, int NA, typename F>
__device__ __forceinline__ void f32_run(float (&acc)[MT][NA], const Ring& ring, int t0,
                                        uint32_t boff, const int (&py)[MT],
                                        const int (&px)[MT], F src) {
  static_assert(N >= 2 && N % 2 == 0, "a run of pairs of steps");
  constexpr int SL = f32_sl(S);
  uint32_t h0[MT][SL][4], l0[MT][SL][4], h1[MT][SL][4], l1[MT][SL][4];
  float p0[MT][NA], p1[MT][NA];    // written first by a step's first wgmma
  f32_step<S, CQ, false>(acc, p0, p1, h0, l0, ring, py, px, boff, 0, t0, src);
  f32_step<S, CQ, true>(acc, p1, p0, h1, l1, ring, py, px, boff, 1, t0, src);
#pragma unroll 1
  for (int k = 2; k < N; k += 2) {
    f32_step<S, CQ, true>(acc, p0, p1, h0, l0, ring, py, px, boff, k, t0, src);
    f32_step<S, CQ, true>(acc, p1, p0, h1, l1, ring, py, px, boff, k + 1, t0, src);
  }
  wgmma_wait<0>();
  f32_fold(acc, p1);
}

// One conv stage S (1..5) of rdb_f32_wg_kernel: x's 72 k-steps, then
// x1..x_{S-1}'s 36 each, in steps of f32_sl(S), every step's partial sums
// added to the running float32 sums (from zero); the stage's last group
// released; then the epilogue (rdb_wg_kernel's, in float32, with
// rdb_kernel<float>'s arithmetic).
template <int S>
__device__ __forceinline__ void f32_stage(const Ring& ring, uint32_t sbase,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ mask,
                                          float* __restrict__ out, int b, int H, int W,
                                          int oy0, int ox0) {
  constexpr int RS = f32_side(S);
  constexpr int NPIX = RS * RS;
  constexpr int MT = f32_mt(S);
  constexpr int NW = f32_nw(S);           // output channels a warpgroup
  constexpr int NA = NW / 2;              // accumulators a thread a tile
  constexpr bool SPLIT = f32_split(S);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col0 = SPLIT ? wg * NW : 0;   // the warpgroup's first channel

  // tile of the warpgroup's m-th: every tile (SPLIT) or w + 2m
  int py[MT], px[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int tile = SPLIT ? m : wg + WGS * m;
    int p = tile * 64 + warp * 16 + (lane & 15);
    p = p < NPIX ? p : NPIX - 1;
    py[m] = p / RS;
    px[m] = p % RS;
  }
  // accumulator (m, i = 4k + 2h + e) is tile pixel 16 warp + g + 8h at
  // channel col0 + 8k + 2t + e
  float acc[MT][NA];
  zero_acc(acc);
  const uint32_t boff = (uint32_t)col0 * 128;
  const Src xs = {sbase, f32_side(0), S - 1, 8};
  constexpr int SL = f32_sl(S);
  f32_run<f32_src_steps(0) / SL, 16, S>(acc, ring, 0, boff, py, px, [&](int k, int& kk) {
    kk = k;
    return xs;
  });
  if constexpr (S > 1) {
    f32_run<(f32_steps(S) - f32_src_steps(0)) / SL, 8, S>(acc, ring, f32_src_steps(0), boff,
                                                          py, px, [&](int k, int& kk) {
      const int j = 1 + k / f32_src_steps(1);
      kk = k % f32_src_steps(1);
      const uint32_t off = j == 1   ? f32_off(1)
                           : j == 2 ? f32_off(2)
                           : j == 3 ? f32_off(3)
                                    : f32_off(4);
      return Src{sbase + off, f32_side(j), S - 1 - j, 4};
    });
  }
  {
    constexpr int U = f32_upg(S);
    constexpr int LAST = f32_unit0(S + 1) - U;
    ring_release<F32_NBUF>(ring, LAST);
    if constexpr (U == 2) ring_release<F32_NBUF>(ring, LAST + 1);
  }

  // epilogue: biases, mask and x's residual in registers before any store
  float bv[NW / 8][2];
#pragma unroll
  for (int k = 0; k < NW / 8; ++k) {
    bv[k][0] = __ldg(bias + (S - 1) * G + col0 + 8 * k + 2 * t);
    bv[k][1] = __ldg(bias + (S - 1) * G + col0 + 8 * k + 2 * t + 1);
  }
  const size_t img_off = (size_t)b * H * W;
  int gy[MT][2], gx[MT][2], pp[MT][2];
  float mk[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tile = SPLIT ? m : wg + WGS * m;
      const int p = tile * 64 + warp * 16 + g + 8 * h;
      constexpr int HS = S < 5 ? HALO - S : 0;
      pp[m][h] = p;
      gy[m][h] = p < NPIX ? oy0 - HS + p / RS : -1;
      gx[m][h] = ox0 - HS + p % RS;
      const bool in = gy[m][h] >= 0 && gy[m][h] < H && gx[m][h] >= 0 && gx[m][h] < W;
      mk[m][h] = !in ? 0.f : (mask ? mask[img_off + (size_t)gy[m][h] * W + gx[m][h]] : 1.f);
    }
  if constexpr (S < 5) {
    // x_S = m(lrelu(acc + b)), 0 outside the image (the SAME padding of the
    // next convs): channels co, co + 1 are bytes 4 (co % 4).. of chunk co / 4
    // of an 8-chunk pixel
    const uint32_t dst = sbase + f32_off(S);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = pp[m][h];
        if (p >= NPIX) continue;
        const bool inside = gy[m][h] >= 0 && gy[m][h] < H && gx[m][h] >= 0 && gx[m][h] < W;
#pragma unroll
        for (int k = 0; k < NW / 8; ++k) {
          const int co = col0 + 8 * k + 2 * t;
          float v0 = acc[m][4 * k + 2 * h] + bv[k][0];
          float v1 = acc[m][4 * k + 2 * h + 1] + bv[k][1];
          v0 = (v0 >= 0.f ? v0 : 0.2f * v0) * mk[m][h];
          v1 = (v1 >= 0.f ? v1 : 0.2f * v1) * mk[m][h];
          if (!inside) v0 = v1 = 0.f;
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                       ::"r"(dst + rot_f32<8>((uint32_t)p, (uint32_t)co >> 2) + 4 * (co & 3)),
                       "f"(v0), "f"(v1) : "memory");
        }
      }
  } else {
    // out = m(0.2 (x5 + b5) + x), x from its resident copy (region 0 has
    // a 5-pixel halo, 16 chunks a pixel), every value read before any store
    float2 xin[MT][2][NW / 8];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool in = gy[m][h] >= 0 && gy[m][h] < H && gx[m][h] < W;
        const int p = pp[m][h];
        const int xp = in ? (p / RS + HALO) * f32_side(0) + p % RS + HALO : 0;
#pragma unroll
        for (int k = 0; k < NW / 8; ++k) {
          const int co = col0 + 8 * k + 2 * t;
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                       : "=f"(xin[m][h][k].x), "=f"(xin[m][h][k].y)
                       : "r"(sbase + rot_f32<16>((uint32_t)xp, (uint32_t)co >> 2) +
                             4 * (co & 3))
                       : "memory");
        }
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (gy[m][h] < 0 || gy[m][h] >= H || gx[m][h] >= W) continue;
        const size_t pix = img_off + (size_t)gy[m][h] * W + gx[m][h];
#pragma unroll
        for (int k = 0; k < NW / 8; ++k) {
          const int co = col0 + 8 * k + 2 * t;
          const float v0 = (acc[m][4 * k + 2 * h] + bv[k][0]) * 0.2f + xin[m][h][k].x;
          const float v1 = (acc[m][4 * k + 2 * h + 1] + bv[k][1]) * 0.2f + xin[m][h][k].y;
          *reinterpret_cast<float2*>(out + pix * NF + co) =
              make_float2(v0 * mk[m][h], v1 * mk[m][h]);
        }
      }
  }
}

// The consumers' part: the input tile with its 5-pixel halo in float32
// (16-byte cp.async copies into chunk c of 16-chunk pixel p, zero-filled
// outside the image: a source size of 0 reads nothing), then the stages.
__device__ __forceinline__ void f32_consume(const Ring& ring, uint32_t sbase,
                                            const float* __restrict__ x,
                                            const float* __restrict__ mask,
                                            float* __restrict__ out,
                                            const float* __restrict__ bias, int H, int W) {
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TILE_F32, ox0 = blockIdx.x * TILE_F32;
  const size_t img_off = (size_t)b * H * W;
  constexpr int R = f32_side(0);
  for (int i = threadIdx.x; i < R * R * 16; i += TC_WARPS * 32) {
    const int p = i >> 4, c = i & 15;
    const int gy = oy0 - HALO + p / R, gx = ox0 - HALO + p % R;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* src = in ? x + (img_off + (size_t)gy * W + gx) * NF + 4 * c : x;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(sbase + rot_f32<16>((uint32_t)p, (uint32_t)c)), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  consumer_sync();
  f32_stage<1>(ring, sbase, bias, mask, out, b, H, W, oy0, ox0);
  consumer_sync();
  f32_stage<2>(ring, sbase, bias, mask, out, b, H, W, oy0, ox0);
  consumer_sync();
  f32_stage<3>(ring, sbase, bias, mask, out, b, H, W, oy0, ox0);
  consumer_sync();
  f32_stage<4>(ring, sbase, bias, mask, out, b, H, W, oy0, ox0);
  consumer_sync();
  f32_stage<5>(ring, sbase, bias, mask, out, b, H, W, oy0, ox0);
}

// The float32 RDB: wb the hi and lo slabs of the five convs as 8 KB units
// (ops/rdb.py::pack_rdb_f32_wg). The roles as wg_body's: warpgroups 0 and 1
// consume with 240 registers a thread, warpgroup 2 gives its registers down
// to 24 and its first thread produces.
__global__ void __launch_bounds__(WG_THREADS, 1)
rdb_f32_wg_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                  float* __restrict__ out, const unsigned char* __restrict__ wb,
                  const float* __restrict__ bias, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  Ring ring;
  ring.slots = (raw + 1023) & ~1023u;
  const uint32_t sbase = ring.slots + F32_NBUF * F32_UNIT;
  ring.full = sbase + f32_off(5);
  ring.empty = ring.full + 8 * F32_NBUF;
  ring.wq = wb;
  ring.wf = nullptr;
  ring.keep = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < F32_NBUF; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(ring.full + 8 * i) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   ::"r"(ring.empty + 8 * i), "r"(TC_WARPS * 32) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == WGS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == WGS * 128) f32_produce(ring);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    f32_consume(ring, sbase, x, mask, out, bias, H, W);
  }
}

int launch_f32_wg(const void* x, const void* mask, void* out, const void* wb,
                  const void* bias, int B, int H, int W, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes();
  const cudaError_t e = cudaFuncSetAttribute(
      rdb_f32_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TILE_F32 - 1) / TILE_F32, (H + TILE_F32 - 1) / TILE_F32, B);
  rdb_f32_wg_kernel<<<grid, WG_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(mask),
      static_cast<float*>(out), static_cast<const unsigned char*>(wb),
      static_cast<const float*>(bias), H, W);
  return (int)cudaGetLastError();
}

// Multiply-adds rdb_f32_wg_kernel executes per output tile (each of three
// TF32 products): each stage's M tiles (stage 3's padded fourth included)
// over all 9 * Cin x Cout.
constexpr long long f32_macs_per_tile() {
  long long macs = 0;
  for (int s = 1; s <= 5; ++s)
    macs += (long long)(f32_split(s) ? 1 : WGS) * f32_mt(s) * 64 * 9 * stage_cin(s) *
            stage_cout(s);
  return macs;
}
static_assert(f32_macs_per_tile() == 34209792, "34.21 M multiply-adds a tile");

// Multiply-adds the wgmma kernels execute per output tile: each stage's
// 2 * wg_mt 64-row M tiles over all 9 * Cin x Cout.
constexpr long long wg_macs_per_tile() {
  long long macs = 0;
  for (int s = 1; s <= 5; ++s)
    macs += (long long)WGS * wg_mt(s) * 64 * 9 * stage_cin(s) * stage_cout(s);
  return macs;
}

constexpr size_t tc_smem_bytes() { return (size_t)tc_off(5); }

int launch_tc(const void* x, const void* mask, void* out, const void* wf,
              const void* bias, int B, int H, int W, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes();
  const cudaError_t e = cudaFuncSetAttribute(
      rdb_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  rdb_tc_kernel<<<tile_grid(B, H, W), TC_WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(out), static_cast<const uint4*>(wf),
      static_cast<const float*>(bias), H, W);
  return (int)cudaGetLastError();
}

// Multiply-adds rdb_tc_kernel executes per output tile: every M tile of each
// stage's region (16 pixels, the last one padded) over all 9 * Cin x Cout.
constexpr long long tc_macs_per_tile() {
  long long macs = 0;
  for (int s = 1; s <= 5; ++s)
    macs += (long long)tc_mtiles(s) * 16 * 9 * stage_cin(s) * stage_cout(s);
  return macs;
}

// Multiply-adds one block executes for its output tile, halo recompute
// included: run_stage's tasks cover each stage's region in whole pixel
// groups, every task over COUT columns and 9 * CIN taps.
template <int TILE>
constexpr long long macs_per_tile() {
  long long macs = 0;
  for (int s = 1; s <= 5; ++s) {
    const int rs = TILE + 2 * (HALO - s);
    const int groups = (rs * rs + 32 * PIX - 1) / (32 * PIX);
    macs += (long long)groups * 32 * PIX * stage_cout(s) * 9 * stage_cin(s);
  }
  return macs;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out: (B, H, W, 64) contiguous;
// mask: (B, H, W) float32 or null; wf: the five convs' weights as the
// dtype's kernel reads them: rdb_f32_wg_kernel's hi and lo TF32 units
// (ops/rdb.py::pack_rdb_f32_wg) or rdb_wg_kernel's bf16 slabs
// (ops/rdb.py::pack_rdb_wg); bias: 192 float32. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int s2sr_rdb_forward(const void* x, const void* mask, void* out,
                                const void* wf, const void* bias, int B, int H,
                                int W, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wf)
    return launch_f32_wg(x, mask, out, wf, bias, B, H, W, st);
  if (dtype == 1 && wf)
    return launch_wg<SERVED>(x, mask, out, wf, bias, B, H, W, st);
  return (int)cudaErrorInvalidValue;
}

// rdb_kernel<float, 8>, the float32 design on the CUDA cores that
// rdb_f32_wg_kernel replaced: x, out (B, H, W, 64) float32; mask as above;
// w the five HWIO kernels flattened and concatenated (float32); bias 192
// float32. Only ops/rdb.py::rdb_ffma calls it (the timing baseline);
// nothing served does. Returns the CUDA error code of the launch.
extern "C" int s2sr_rdb_ffma_forward(const void* x, const void* mask, void* out,
                                     const void* w, const void* bias, int B, int H,
                                     int W, void* stream) {
  if (!w || !bias) return (int)cudaErrorInvalidValue;
  return launch<float, TILE_F32>(x, mask, out, w, bias, B, H, W,
                                 static_cast<cudaStream_t>(stream));
}

// rdb_tc_kernel, the ladder's v4_mma: x, out (B, H, W, 64) bf16; mask as
// above; wf the weights as mma.sync B fragments (ops/rdb.py::
// pack_rdb_fragments); bias 192 float32. Only ops/rdb.py::rdb_mma calls it;
// nothing served does. Returns the CUDA error code of the launch.
extern "C" int s2sr_rdb_mma_forward(const void* x, const void* mask, void* out,
                                    const void* wf, const void* bias, int B, int H,
                                    int W, void* stream) {
  if (!wf || !bias) return (int)cudaErrorInvalidValue;
  return launch_tc(x, mask, out, wf, bias, B, H, W, static_cast<cudaStream_t>(stream));
}

// A time-attribution instance of rdb_wg_kernel (enum Variant: 1 NO_FILL,
// 2 NO_ACC, 3 SERIAL_B) on the operands of s2sr_rdb_forward's bfloat16 path
// (x, out bf16; wf the bf16 slabs; bias 192 float32). Only
// ops/rdb.py::rdb_ablated calls it; nothing served does. Returns the CUDA
// error code of the launch.
extern "C" int s2sr_rdb_ablate_forward(const void* x, const void* mask, void* out,
                                       const void* wf, const void* bias, int B,
                                       int H, int W, int variant, void* stream) {
  if (!wf || !bias) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case NO_FILL: return launch_wg<NO_FILL>(x, mask, out, wf, bias, B, H, W, st);
    case NO_ACC: return launch_wg<NO_ACC>(x, mask, out, wf, bias, B, H, W, st);
    case SERIAL_B: return launch_wg<SERIAL_B>(x, mask, out, wf, bias, B, H, W, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 RDB with its x stage in int8: x, out (B, H, W, 64) bf16; mask as
// above; wf the bf16 slabs of x1..x4's rows (ops/rdb.py::pack_rdb_i8_bf16);
// wq the s8 slabs of the packed x conv (ops/rdb.py::pack_rdb_i8_fragments);
// deq its 192 dequantization factors in packed column order; bias 192
// float32; qm x's quantization multiplier. Returns the CUDA error code of the
// launch.
extern "C" int s2sr_rdb_i8_forward(const void* x, const void* mask, void* out,
                                   const void* wf, const void* wq,
                                   const void* deq, const void* bias, float qm,
                                   int B, int H, int W, void* stream) {
  if (!wf || !wq || !deq) return (int)cudaErrorInvalidValue;
  return launch_i8(x, mask, out, wf, wq, deq, bias, qm, B, H, W,
                   static_cast<cudaStream_t>(stream));
}

// The full-W8A8 RDB: x, out (B, H, W, 64) bf16; mask as above; wq the s8 slabs
// of the five packed kernels (ops/rdb.py::pack_rdb_w8a8); deq the
// 640 dequantization factors of x, x1..x4 concatenated; qm their 5
// quantization multipliers; bias 192 float32. Returns the CUDA error code of
// the launch.
extern "C" int s2sr_rdb_w8a8_forward(const void* x, const void* mask, void* out,
                                     const void* wq, const void* deq,
                                     const void* qm, const void* bias, int B,
                                     int H, int W, void* stream) {
  if (!wq || !deq || !qm || !bias) return (int)cudaErrorInvalidValue;
  return launch_w8a8(x, mask, out, wq, deq, qm, bias, B, H, W,
                     static_cast<cudaStream_t>(stream));
}

extern "C" long long s2sr_rdb_w8a8_smem_bytes() {
  return (long long)wg_smem_bytes<KW8>();
}

extern "C" long long s2sr_rdb_i8_smem_bytes() {
  return (long long)wg_smem_bytes<KI8>();
}

// Multiply-adds the wgmma kernels (rdb_wg_kernel, rdb_i8_kernel,
// rdb_w8a8_kernel) execute per output tile (64-row M tiles, halo included).
extern "C" long long s2sr_rdb_i8_macs_per_tile() { return wg_macs_per_tile(); }

// rdb_tc_kernel's (v4_mma's) shared-memory bytes and multiply-adds a tile.
extern "C" long long s2sr_rdb_mma_smem_bytes() { return (long long)tc_smem_bytes(); }
extern "C" long long s2sr_rdb_mma_macs_per_tile() { return tc_macs_per_tile(); }

// rdb_kernel<float>'s (rdb_ffma's) shared-memory bytes and multiply-adds a
// tile (its tile is the float32 kernel's, 8).
extern "C" long long s2sr_rdb_ffma_smem_bytes() {
  return (long long)smem_bytes<float, TILE_F32>();
}
extern "C" long long s2sr_rdb_ffma_macs_per_tile() { return macs_per_tile<TILE_F32>(); }

// Output tile side and dynamic shared-memory bytes per block, by dtype.
extern "C" int s2sr_rdb_tile(int dtype) {
  return dtype == 0 ? TILE_F32 : TC_TILE;
}

extern "C" long long s2sr_rdb_smem_bytes(int dtype) {
  return dtype == 0 ? (long long)f32_smem_bytes() : (long long)wg_smem_bytes<KBF>();
}

// Multiply-adds executed per output tile (halo included), by dtype: for
// float32 those of each of rdb_f32_wg_kernel's three TF32 products.
extern "C" long long s2sr_rdb_macs_per_tile(int dtype) {
  return dtype == 0 ? f32_macs_per_tile() : wg_macs_per_tile();
}

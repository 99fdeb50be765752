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
// kernel's time is its arithmetic. This first version does that
// arithmetic on the CUDA cores in float32 FMA (67 TFLOP/s peak), not on
// the tensor cores (989 TFLOP/s bf16); wgmma is the next step.
//
// Structure: each thread block owns one TILE x TILE output tile of one
// image. It loads the input with a 5-pixel halo into dynamic shared
// memory (zero outside the image), then computes x1..x4 over regions
// that shrink by one pixel per side per stage (halo 4, 3, 2, 1), each
// stored planar [channel][y][x] so that the 32 lanes of a warp read 32
// neighbouring pixels of one channel without bank conflicts. Finally x5
// and the residual over the tile itself go straight to device memory.
// A warp task is 128 pixels (4 per lane) x 16 output channels: per
// (tap, input channel) a lane does 4 shared loads, 4 uniform 16-byte
// weight loads (broadcast from L1/L2) and 64 FMAs.
//
// Tiles: bf16 16x16 (200,704 B shared), fp32 8x8 (172,032 B shared),
// both under the 227 KB a block may opt into.

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

constexpr int TILE_BF16 = 16;
constexpr int TILE_F32 = 8;

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
// mask: (B, H, W) float32 or null; w: the five HWIO conv kernels
// flattened and concatenated (float32); bias: 192 float32.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int s2sr_rdb_forward(const void* x, const void* mask, void* out,
                                const void* w, const void* bias, int B, int H,
                                int W, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, TILE_F32>(x, mask, out, w, bias, B, H, W, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, TILE_BF16>(x, mask, out, w, bias, B, H, W,
                                            st);
  return (int)cudaErrorInvalidValue;
}

// Output tile side and dynamic shared-memory bytes per block, by dtype.
extern "C" int s2sr_rdb_tile(int dtype) {
  return dtype == 0 ? TILE_F32 : TILE_BF16;
}

extern "C" long long s2sr_rdb_smem_bytes(int dtype) {
  return dtype == 0 ? (long long)smem_bytes<float, TILE_F32>()
                    : (long long)smem_bytes<__nv_bfloat16, TILE_BF16>();
}

// Multiply-adds executed per output tile (halo included), by dtype.
extern "C" long long s2sr_rdb_macs_per_tile(int dtype) {
  return dtype == 0 ? macs_per_tile<TILE_F32>() : macs_per_tile<TILE_BF16>();
}

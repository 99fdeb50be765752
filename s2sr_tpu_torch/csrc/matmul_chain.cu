// Chained bf16 matrix products on the tensor cores, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels of the matrix-unit microbenchmark
// scripts/bench_mxu.py: _pallas_chain (:60, body _dot_kernel :41-57) and
// _pair_chain (:169, body _pair_kernel :146-166). Both carry a bf16
// activation through `repeat` products with float32 accumulation, each
// product's output rounded to bf16 (round to nearest even, as .astype):
//
//   chain:  acc = x;  repeat times:  acc = bf16(acc @ W)                W (K, K)
//   pair:   acc = x;  repeat times:  acc = bf16(bf16(acc @ w1) @ w2)    w1 (K, N), w2 (N, K)
//
// x and the result are (M, K), row-major. The point of the function is the
// rate of the matrix unit with the operands kept on chip, so every product
// runs on the tensor cores: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// A from shared memory through ldmatrix, B as 16-byte fragment loads.
//
// What bounds it: operations. 2*M*K*K*repeat FLOP (chain; 4*M*K*N*repeat
// for the pair) at 989 TFLOP/s against (M*K*2 in and out + the weights)
// bytes at 3.35 TB/s: at M = 27,840, K = 192, repeat 1024 that is 2.13 ms
// against 6.4 us. The design keeps every byte of the chain on chip:
//
// - Rows are independent, so each warp owns 16 rows (one m16 tile) and runs
//   all `repeat` steps on them alone: the carry lives in the warp's own rows
//   of shared memory, and no block-wide barrier follows the weights' load.
//   Step i+1 reads every column of step i's output, so a product first
//   loads its whole A operand (16 x K, K/4 registers a lane) into
//   registers, and only then writes its output over the carry, 64 columns
//   at a time from float32 accumulators; __syncwarp orders the two.
// - The weights are packed by the wrapper into the mma B-fragment order
//   (ops/matmul_chain.py::pack_fragments): one 16-byte load per lane gives
//   the fragments of a 16 x 16 slab, conflict-free, and each is loaded one
//   k-slab ahead of the products that use it. They are copied into shared
//   memory once per block where they fit beside at least 4 warps' carry
//   (K*K*2 bytes: 72 KB at K = 192, 128 KB at K = 256), and read from L2
//   where they do not (K = 512: 512 KB; the 384 x 192 pair: 288 KB).
// - Staging (the `stage` variants) writes each product's output in more
//   copies side by side in the row, as the TPU kernel writes its (MT, 3K)
//   stage: the chain 3 copies, the pair 2 (the carry and one stage slot).
//   Slot 0 is the next A operand in every variant, so staging changes no
//   value; the extra copies are real shared-memory stores (their count is
//   a runtime argument). The carry of an mma.sync chain must pass through
//   shared memory anyway (ldmatrix reads it there), so the unstaged kernel
//   already stores one copy per product.
// - The A operand's registers are sized for the widest K of the template
//   (KMAX 128, 256 or 512); K and N are runtime multiples of 16 up to it.
//   A block has 16 warps at KMAX 128 and 8 above (the registers), fewer
//   where shared memory runs out. The ragged last row block is masked:
//   rows past M load zeros and are not stored.
//
// Not here yet: wgmma, TMA and warp specialisation, and K-slab staging of
// weights that do not fit shared memory (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the dynamic shared memory of every kernel here
extern __shared__ __align__(16) unsigned char smem[];

namespace {

constexpr int PAD = 8;                  // bf16 pad per shared row: 16 bytes
constexpr int MAX_WIDTH = 512;
constexpr long long SMEM_LIMIT = 232448;

typedef __nv_bfloat16 bf16;

constexpr int WARP_ROWS = 16;           // rows a warp owns: one m16 tile
constexpr int CT = 4;                   // n16 tiles of a register chunk: 64 columns

// Warps per block by the register class of A (KMAX): ptxas gives the 128
// class 128 registers a lane, so 16 warps fit the SM's 65,536; the 256 and
// 512 classes take up to 193 and 248, so 8.
__host__ __device__ constexpr int max_warps(int kmax) {
  return kmax == 128 ? 16 : 8;
}

// The launch plan of one (K, N, pair, stage): warps per block, whether the
// weights sit in shared memory, the shared row stride of the carry (in
// bf16), the copies stored per product, the register class of A and the
// dynamic shared bytes.
struct Plan {
  int warps;
  int w_smem;
  int ldc;
  int copies;
  int kmax;
  long long smem;
};

Plan make_plan(int k, int n, int pair, int stage) {
  Plan p;
  const int width = pair && n > k ? n : k;          // widest product output
  p.copies = stage ? (pair ? 2 : 3) : 1;
  p.ldc = p.copies * width + PAD;
  p.kmax = width <= 128 ? 128 : width <= 256 ? 256 : 512;
  const long long carry = 2LL * WARP_ROWS * p.ldc;  // bytes per warp
  const long long wbytes = pair ? 4LL * k * n : 2LL * k * k;
  const long long cap = max_warps(p.kmax);
  // the weights in shared memory if at least 4 warps' carry fits beside
  const long long fit = (SMEM_LIMIT - wbytes) / carry;
  p.w_smem = fit >= 4;
  const long long nw = p.w_smem ? fit : SMEM_LIMIT / carry;
  p.warps = (int)(nw < cap ? nw : cap);
  p.smem = (p.w_smem ? wbytes : 0) + p.warps * carry;
  return p;
}

struct Args {
  const bf16* x;
  bf16* out;
  const uint4* w[2];     // fragment-packed weights (w1, w2 of the pair)
  int m, k, n, pair, repeat, copies, ldc;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A fragments of one 16 x 16 tile: lane l gives the address of row l % 16,
// column 8 * (l / 16), so matrices 0..3 are rows 0-7 / 8-15 of columns
// 0-7, then of columns 8-15: the a0..a3 order of m16n8k16.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values rounded to nearest even, packed: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The B fragments of slab (kt, the chunk's n16 tiles c0..c0+CT-1), one
// 16-byte load a lane each; tiles past the last are clamped to it (loaded,
// not used), so that the loads carry no branch.
template <bool W_SMEM>
__device__ __forceinline__ void load_b(uint4 (&b)[CT], const uint4* __restrict__ wg,
                                       int woff, int kt, int c0, int nt,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int idx = (kt * nt + min(c0 + j, nt - 1)) * 32 + lane;
    if constexpr (W_SMEM) b[j] = reinterpret_cast<const uint4*>(smem)[woff + idx];
    else b[j] = __ldg(wg + idx);
  }
}

// One product of the warp's 16 rows: carry[:, :kout] = bf16(carry[:, :kin]
// @ W), written into `copies` slots of width `sw`. W is fragment-packed,
// [kin/16][kout/16][lane][8 bf16]: at uint4 `woff` of shared memory
// (W_SMEM), else at `wg` in device memory. The B fragments of slab kt + 1
// are loaded before the products of slab kt.
template <int KMAX, bool W_SMEM>
__device__ __forceinline__ void product(bf16* carry, int ldc, int sw,
                                        int copies, int kin, int kout,
                                        const uint4* __restrict__ wg, int woff,
                                        int lane) {
  constexpr int KT = KMAX / 16;
  const int nk = kin / 16, nt = kout / 16;
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[KT][4];
  const uint32_t abase = smem_addr(carry + (lane & 15) * ldc + (lane >> 4) * 8);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    if (kt < nk) ldmatrix_x4(a[kt], abase + kt * 32);
  __syncwarp();                           // every lane holds its A: write over it

  for (int c0 = 0; c0 < nt; c0 += CT) {
    float acc[CT][2][4];
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.f;
    const int jn = nt - c0;               // n16 tiles left in this chunk
    uint4 b[CT], bn[CT];
    load_b<W_SMEM>(b, wg, woff, 0, c0, nt, lane);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt >= nk) break;
      load_b<W_SMEM>(bn, wg, woff, min(kt + 1, nk - 1), c0, nt, lane);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        if (j >= jn) break;
        mma(acc[j][0], a[kt], b[j].x, b[j].y);
        mma(acc[j][1], a[kt], b[j].z, b[j].w);
      }
#pragma unroll
      for (int j = 0; j < CT; ++j) b[j] = bn[j];
    }
    // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      if (j >= jn) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (c0 + j) * 16 + h * 8 + 2 * t;
        const uint32_t lo = pack_bf16(acc[j][h][0], acc[j][h][1]);
        const uint32_t hi = pack_bf16(acc[j][h][2], acc[j][h][3]);
        bf16* row = carry + g * ldc + col;
        for (int s = 0; s < copies; ++s) {
          *reinterpret_cast<uint32_t*>(row + s * sw) = lo;
          *reinterpret_cast<uint32_t*>(row + 8 * ldc + s * sw) = hi;
        }
      }
    }
  }
  __syncwarp();                           // the output is the next A
}

template <int KMAX, bool W_SMEM>
__global__ void __launch_bounds__(max_warps(KMAX) * 32, 1)
chain_kernel(Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nprod = a.pair ? 2 : 1;
  const int sw = a.pair && a.n > a.k ? a.n : a.k;    // slot width
  const int n0 = a.k * a.n / 8;                      // uint4s of w1
  const int nw = a.pair ? 2 * n0 : n0;
  bf16* carry = reinterpret_cast<bf16*>(smem);
  if constexpr (W_SMEM) {
    uint4* ws = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < nw; i += blockDim.x)
      ws[i] = __ldg(i < n0 ? a.w[0] + i : a.w[1] + (i - n0));
    carry = reinterpret_cast<bf16*>(ws + nw);
    __syncthreads();
  }
  const int row0 = (blockIdx.x * (blockDim.x >> 5) + warp) * WARP_ROWS;
  if (row0 >= a.m) return;                // no block barrier follows
  carry += warp * WARP_ROWS * a.ldc;

  // x into every slot (the TPU kernel stages x too), zero past M
  const int v8 = a.k / 8;                 // uint4s per row
  for (int i = lane; i < WARP_ROWS * v8; i += 32) {
    const int r = i / v8, c = (i % v8) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < a.m)
      v = __ldg(reinterpret_cast<const uint4*>(a.x + (size_t)(row0 + r) * a.k + c));
    for (int s = 0; s < a.copies; ++s)
      *reinterpret_cast<uint4*>(carry + r * a.ldc + s * sw + c) = v;
  }
  __syncwarp();

  // product p maps width kin to kout: the chain K -> K; the pair K -> N,
  // then N -> K
  for (int step = 0; step < a.repeat; ++step)
    for (int p = 0; p < nprod; ++p)
      product<KMAX, W_SMEM>(carry, a.ldc, sw, a.copies, p ? a.n : a.k,
                            p ? a.k : a.n, p ? a.w[1] : a.w[0], p ? n0 : 0,
                            lane);

  for (int i = lane; i < WARP_ROWS * v8; i += 32) {
    const int r = i / v8, c = (i % v8) * 8;
    if (row0 + r < a.m)
      *reinterpret_cast<uint4*>(a.out + (size_t)(row0 + r) * a.k + c) =
          *reinterpret_cast<const uint4*>(carry + r * a.ldc + c);
  }
}

template <int KMAX, bool W_SMEM>
int launch(const Args& a, const Plan& p, cudaStream_t stream) {
  void (*kernel)(Args) = chain_kernel<KMAX, W_SMEM>;
  // set on every launch, so that it holds on whichever device is current
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = p.warps * WARP_ROWS;
  kernel<<<(a.m + rows - 1) / rows, p.warps * 32, (size_t)p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KMAX>
int launch_kmax(const Args& a, const Plan& p, cudaStream_t stream) {
  return p.w_smem ? launch<KMAX, true>(a, p, stream)
                  : launch<KMAX, false>(a, p, stream);
}

bool valid(int m, int k, int n, int pair, int repeat) {
  const auto dim_ok = [](int d) { return d >= 16 && d <= MAX_WIDTH && d % 16 == 0; };
  return m >= 1 && repeat >= 0 && dim_ok(k) && (!pair || dim_ok(n));
}

}  // namespace

// x, out: (M, K) bf16, contiguous, 16-byte aligned. w1: the chain's W (K, K)
// or the pair's w1 (K, N); w2: the pair's w2 (N, K), unused by the chain;
// both fragment-packed bf16 (ops/matmul_chain.py::pack_fragments). pair: 0
// chain, 1 pair; stage: 0 or 1. K and N are multiples of 16 in [16, 512].
// Returns the CUDA error code of the launch (0 = success).
extern "C" int s2sr_matmul_chain_forward(const void* x, void* out,
                                         const void* w1, const void* w2, int M,
                                         int K, int N, int repeat, int pair,
                                         int stage, void* stream) {
  if (!valid(M, K, N, pair, repeat)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(K, N, pair, stage);
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.w[0] = static_cast<const uint4*>(w1);
  a.w[1] = static_cast<const uint4*>(pair ? w2 : w1);
  a.m = M;
  a.k = K;
  a.n = pair ? N : K;
  a.pair = pair;
  a.repeat = repeat;
  a.copies = p.copies;
  a.ldc = p.ldc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.kmax) {
    case 128: return launch_kmax<128>(a, p, st);
    case 256: return launch_kmax<256>(a, p, st);
    default: return launch_kmax<512>(a, p, st);
  }
}

// The launch plan of a (K, N, pair, stage): what = 0 rows per block, 1
// dynamic shared-memory bytes per block, 2 whether the weights sit in
// shared memory (1) or are read from L2 (0), 3 warps per block, 4 the
// register class of A (KMAX), 5 copies of each product's output stored;
// -1 for an unknown field or shape.
extern "C" long long s2sr_matmul_chain_query(int K, int N, int pair, int stage,
                                             int what) {
  if (!valid(1, K, N, pair, 0)) return -1;
  const Plan p = make_plan(K, N, pair, stage);
  switch (what) {
    case 0: return (long long)p.warps * WARP_ROWS;
    case 1: return p.smem;
    case 2: return p.w_smem;
    case 3: return p.warps;
    case 4: return p.kmax;
    case 5: return p.copies;
  }
  return -1;
}

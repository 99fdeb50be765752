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
// runs on the tensor cores.
//
// What bounds it: operations. 2*M*K*K*repeat FLOP (chain; 4*M*K*N*repeat
// for the pair) at 989 TFLOP/s against (M*K*2 in and out + the weights)
// bytes at 3.35 TB/s: at M = 27,840, K = 192, repeat 1024 that is 2.13 ms
// against 6.4 us. Both paths keep every byte of the chain on chip. Rows are
// independent, so a warpgroup or a warp owns its rows for all `repeat`
// steps and no block-wide barrier follows the weights' load.
//
// - wgmma (wg_chain_kernel, the path wherever an instance exists and W
//   fits shared memory): the carry stays in registers from step to step;
//   the section "the wgmma path" below says how.
// - wgmma with W streamed (wg_ring_chain_kernel: the unstaged chain at
//   K 512 and the unstaged 384 x 192 pair, whose W, 512 and 288 KB, does
//   not fit a block): W goes through a ring of slabs in shared memory
//   every step; design="multicast" runs its instance that multicasts each
//   slab to both blocks of a 2-block cluster, which nothing serves (it is
//   slower); the section "the ring path" below says how.
// - mma.sync (chain_kernel: the staged variants at those two shapes,
//   widths without a wgmma instance, and design="mma" at any shape, a
//   timing baseline): mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
//   A from shared memory through ldmatrix, B as 16-byte fragment loads.
//   Each warp owns 16 rows (one m16 tile): the carry lives in the warp's
//   own rows of shared memory. Step i+1 reads every column of step i's
//   output, so a product first loads its whole A operand (16 x K, K/4
//   registers a lane) into registers, and only then writes its output over
//   the carry, 64 columns at a time from float32 accumulators; __syncwarp
//   orders the two. The weights are packed by the wrapper into the mma
//   B-fragment order (ops/matmul_chain.py::pack_fragments): one 16-byte
//   load per lane gives the fragments of a 16 x 16 slab, conflict-free,
//   each loaded one k-slab ahead of the products that use it, from shared
//   memory where they fit beside at least 4 warps' carry, else from L2
//   (K = 512: 512 KB; the 384 x 192 pair: 288 KB). The A operand's
//   registers are sized for the widest K of the template (KMAX 128, 256 or
//   512); a block has 16 warps at KMAX 128 and 8 above (the registers),
//   fewer where shared memory runs out.
// - Staging (the `stage` variants) writes each product's output in more
//   copies side by side in a row of shared memory, as the TPU kernel
//   writes its (MT, 3K) stage: the chain 3 copies, the pair 2. Slot 0 is
//   read back as the next A operand, so staging changes no value; the
//   copies are real shared-memory stores (their count is a runtime
//   argument). On the mma.sync path the carry itself is slot 0.
// - The ragged last row block is masked: rows past M load zeros and are
//   not stored.

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
  int wgmma;             // 1: the B operand packed for wgmma, 0: for mma.sync
  int path;              // 0 chain_kernel, 1 wg_chain_kernel, 2 wg_ring_chain_kernel
  int threads;           // threads a block
  int slots;             // slots of the B ring (the ring path), else 0
  int cluster;           // blocks a cluster (2: the ring's multicast), else 1
  int cols;              // columns of a B slab (the ring path), else 0
};

// The kernels a call can launch: the served route for its shape, the ring
// kernel's multicast instance on a 2-block cluster (MULTICAST, ring shapes
// only) and chain_kernel (MMA, any shape): the last two are timing
// baselines nothing serves.
enum Design : int { SERVED = 0, MULTICAST = 1, MMA = 2 };

Plan make_mma_plan(int k, int n, int pair, int stage) {
  Plan p;
  p.wgmma = 0;
  p.path = 0;
  p.slots = 0;
  p.cluster = 1;
  p.cols = 0;
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
  p.threads = p.warps * 32;
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

// --- the wgmma path ---------------------------------------------------------
//
// One warpgroup (4 warps, 128 threads) owns 64 rows for all `repeat` steps,
// and the carry never leaves registers. wgmma.mma_async takes A from
// registers in the layout of mma.m16n8k16's A fragment (warp w: rows
// 16w..16w+15), and its float32 accumulator gives, for each 16 columns,
// the values of one k16 slab of that layout: d[8s..8s+7] are rows g, g+8 of
// columns 16s + 2t (+1) and 16s + 8 + 2t (+1). So bf16(acc) is the next
// product's A with one cvt.rn.bf16x2 per pair: no shuffle, no shared
// memory. W sits in shared memory as the wgmma canonical K-major image with
// the 128-byte swizzle (ops/matmul_chain.py::pack_wgmma builds it): blocks of
// 64 K values, each N rows of 128 bytes, the 16-byte chunk c of row n at
// chunk c ^ (n % 8). One cp.async.bulk per weight matrix brings it in,
// completing on an mbarrier. Blocks are persistent, one per SM, with NWG
// warpgroups that walk 64-row tiles; while one warpgroup converts its
// accumulator, another's wgmmas run.

constexpr int WG_ROWS = 64;
constexpr int WG_THREADS = 128;

// wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16 with A from registers
// and B from the descriptor: d (N/2 floats) = A @ B (+ d if scale_d)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<144>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory descriptor of a K-major, 128-byte-swizzled B operand at
// shared address `addr`: 8-row groups 1024 bytes apart (SBO 64), the
// leading offset unused by this layout (1), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

// Bytes of one weight matrix's image: K padded to 64, times N, bf16.
__host__ __device__ constexpr int image_bytes(int kin, int nout) {
  return (kin + 63) / 64 * 64 * nout * 2;
}

// acc (N floats of this thread) = A (64 x KIN, registers) @ W, W's image at
// shared address `w`. N above 256 runs as two halves of N / 2 columns.
template <int KIN, int NOUT>
__device__ __forceinline__ void wg_product(float (&acc)[NOUT / 2],
                                           const uint32_t (&a)[KIN / 16][4],
                                           uint32_t w) {
  constexpr int PARTS = NOUT > 256 ? 2 : 1;
  constexpr int NI = NOUT / PARTS;
  static_assert(NI % 16 == 0 && NI <= 256, "wgmma N");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KIN / 16; ++kk) {
    const uint32_t kaddr = w + (kk / 4) * NOUT * 128 + (kk % 4) * 32;
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
      wgmma_rs<NI>(acc + p * (NI / 2), a[kk], b_desc(kaddr + p * NI * 128),
                   kk > 0);
  }
  wgmma_commit_wait();
}

template <int W>
__device__ __forceinline__ void to_operand(uint32_t (&a)[W / 16][4],
                                           const float (&acc)[W / 2]) {
#pragma unroll
  for (int s = 0; s < W / 16; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[s][r] = pack_bf16(acc[8 * s + 2 * r], acc[8 * s + 2 * r + 1]);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Staging: the operand (64 x W, row-major in the stage, row stride ldc
// bf16) stored into `copies` slots side by side, then read back from slot
// 0; each thread reads back what it stored.
template <int W>
__device__ __forceinline__ void stage_operand(uint32_t (&a)[W / 16][4],
                                              uint32_t stage, int ldc,
                                              int copies, int sw, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < W / 16; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r & 1), col = 16 * s + 8 * (r >> 1) + 2 * t;
      const uint32_t at = stage + 2 * (row * ldc + col);
      for (int c = 0; c < copies; ++c) st_shared(at + 2 * c * sw, a[s][r]);
      a[s][r] = ld_shared(at);
    }
}

struct WgArgs {
  const bf16* x;
  bf16* out;
  const void* w[2];      // smem images of w1, w2 (ops/matmul_chain.py::pack_wgmma)
  int m, repeat, copies, ldc;
};

// Rows of this warp's A fragment through x or out: r = 0..3 of slab s at
// rows g (+8), columns 16s + 2t (+8).
template <int K, bool LOAD>
__device__ __forceinline__ void rows_io(uint32_t (&a)[K / 16][4],
                                        const bf16* x, bf16* out, int row0,
                                        int m, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < K / 16; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + 8 * (r & 1);
      const size_t at = (size_t)row * K + 16 * s + 8 * (r >> 1) + 2 * t;
      if constexpr (LOAD)
        a[s][r] = row < m ? __ldg(reinterpret_cast<const unsigned int*>(x + at))
                          : 0u;
      else if (row < m)
        *reinterpret_cast<uint32_t*>(out + at) = a[s][r];
    }
}

template <int K, int N, bool PAIR, int NWG>
__global__ void __launch_bounds__(NWG * WG_THREADS, 1) wg_chain_kernel(WgArgs p) {
  constexpr int B1 = image_bytes(K, N);
  constexpr int B2 = PAIR ? image_bytes(N, K) : 0;
  const uint32_t raw = smem_addr(smem);
  const uint32_t w1 = (raw + 1023) & ~1023u;        // the swizzle's 1024-byte atoms
  const uint32_t bar = w1 + B1 + B2;
  const uint32_t stage0 = bar + 16;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(B1 + B2) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 ::"r"(w1), "l"(p.w[0]), "r"(B1), "r"(bar) : "memory");
    if constexpr (PAIR)
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                   "[%0], [%1], %2, [%3];\n"
                   ::"r"(w1 + B1), "l"(p.w[1]), "r"(B2), "r"(bar) : "memory");
  }
  {
    uint32_t done = 0;
    while (!done)
      asm volatile("{\n.reg .pred q;\n"
                   "mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n"
                   "selp.u32 %0, 1, 0, q;\n}\n"
                   : "=r"(done) : "r"(bar), "r"(0) : "memory");
  }
  const int wg = threadIdx.x / WG_THREADS, nwg = blockDim.x / WG_THREADS;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  constexpr int SW = PAIR && N > K ? N : K;            // stage slot width
  const uint32_t stage = stage0 + 2 * (wg * WG_ROWS + warp * 16) * p.ldc;
  const int tiles = (p.m + WG_ROWS - 1) / WG_ROWS;
  for (int tile = blockIdx.x * nwg + wg; tile < tiles; tile += gridDim.x * nwg) {
    const int row0 = tile * WG_ROWS + warp * 16;
    uint32_t a[K / 16][4];
    rows_io<K, true>(a, p.x, nullptr, row0, p.m, lane);
    if (p.copies) stage_operand<K>(a, stage, p.ldc, p.copies, SW, lane);
    for (int step = 0; step < p.repeat; ++step) {
      if constexpr (PAIR) {
        uint32_t mid[N / 16][4];
        {
          float acc[N / 2];
          wg_product<K, N>(acc, a, w1);
          to_operand<N>(mid, acc);
        }
        if (p.copies) stage_operand<N>(mid, stage, p.ldc, p.copies, SW, lane);
        float acc[K / 2];
        wg_product<N, K>(acc, mid, w1 + B1);
        to_operand<K>(a, acc);
      } else {
        float acc[K / 2];
        wg_product<K, K>(acc, a, w1);
        to_operand<K>(a, acc);
      }
      if (p.copies) stage_operand<K>(a, stage, p.ldc, p.copies, SW, lane);
    }
    rows_io<K, false>(a, nullptr, p.out, row0, p.m, lane);
  }
}

// The wgmma instances: (K, N, pair, warpgroups per block). Warpgroups by
// the registers a thread holds (A of the widest input, the accumulator of
// the widest output): 4 under 128 registers, 3 under 168, else 2.
struct WgInstance {
  int k, n, pair, nwg;
  void (*kernel)(WgArgs);
};
const WgInstance WG_INSTANCES[] = {
    {64, 64, 0, 4, wg_chain_kernel<64, 64, false, 4>},
    {96, 96, 0, 4, wg_chain_kernel<96, 96, false, 4>},
    {128, 128, 0, 3, wg_chain_kernel<128, 128, false, 3>},
    {160, 160, 0, 3, wg_chain_kernel<160, 160, false, 3>},
    {192, 192, 0, 2, wg_chain_kernel<192, 192, false, 2>},
    {256, 256, 0, 2, wg_chain_kernel<256, 256, false, 2>},
    {64, 128, 1, 3, wg_chain_kernel<64, 128, true, 3>},
    {96, 128, 1, 3, wg_chain_kernel<96, 128, true, 3>},
    {96, 160, 1, 3, wg_chain_kernel<96, 160, true, 3>},
    {288, 128, 1, 2, wg_chain_kernel<288, 128, true, 2>},
};

const WgInstance* find_instance(int k, int n, int pair) {
  for (const WgInstance& w : WG_INSTANCES)
    if (w.k == k && w.n == (pair ? n : k) && w.pair == pair) return &w;
  return nullptr;
}

// --- the ring path ------------------------------------------------------------
//
// wg_ring_chain_kernel<K, N, PAIR, MCAST> serves the unstaged chain at K 512
// and the unstaged 384 x 192 pair, whose weights (512 KB; w1 + w2 288 KB)
// do not fit the block's 232,448 B. Under chain_kernel each warp read every
// B fragment of W from L2 every step (16 rows of work a byte of W, ~16
// FLOP a byte: 934 GB of fragment loads a launch at K 512, M 27,840,
// repeat 1024), and the tensor cores idled behind them.
//
// Each step needs all of W, so each block streams W once a step through
// shared memory and shares every slab among all of its rows: the FLOP a
// byte of W streamed equals the rows that share the slab. With 128 rows a
// block, L2 would have to give 989e12 / 128 ~ 7.7 TB/s to keep up with the
// tensor cores, above the ~4.7 TB/s copy rate measured on this card; with
// each slab multicast to both blocks of a 2-block cluster (256 rows a
// slab), 3.9 TB/s. At K 512, M 27,840, repeat 1024 that is 218 row tiles x
// 1024 steps x 512 KiB = 117 GB from L2 a launch (58.5 GB with the
// cluster); the pair 65.8 GB (32.9 GB). On the card (chip_smoke.py phase
// mxu, NVIDIA H100) L2 gave the 128-row blocks more than 5 TB/s, and the
// served ring, without the cluster, runs close to the tensor cores' rate;
// the multicast instance, which halves the L2 reads, runs slower: every
// slot it refills waits for both blocks' readers, which couples the two
// SMs. So the served route is the ring without the cluster, and the
// multicast instance (MCAST) is timed beside it (design="multicast").
//
// A block: 256 threads, two warpgroups of 64 rows each, one block an SM
// (__launch_bounds__(256, 1)), and no producer. Registers set the shape:
// the chain at K 512 holds A (64 x 512 bf16: 128 registers) and a
// 128-column float32 accumulator (64), 192 and addressing; the pair holds
// x (96) and a 192-column accumulator (96) in product 1, and in product 2
// mid (48), the first half's packed output (48) and a 192-column
// accumulator (96). ptxas allocates every thread the launch's share,
// counting warps in fours and whatever setmaxnreg grants at run time:
// with a producer warp (288 threads) or warpgroup (384) it held these
// threads to 168 registers, spilling 0.4-4.5 KB a thread with the wgmmas
// serialised (C7512; NVIDIA H100, measured on the way to this design).
// 256 threads leave 255.
//
// W is packed once a call into slabs of 64 K values x COLS columns in the
// wgmma K-major image with the 128-byte swizzle (pack_wgmma's layout, one
// slab = one K block of it), in the order the consumers read them
// (ops/matmul_chain.py::pack_wgmma_slabs). One cp.async.bulk a slab,
// completing on the slot's `full` mbarrier in each block it lands in.
// Without a producer, the consumers refill the ring themselves: each
// warp's lane 0, once the warp's wgmmas on a slab have completed, adds one
// to its block's count of the slot (atom.shared); the warp that completes
// the block's count of 8 adds one to the cluster's count of the slot (in
// the rank-0 block, through mapa; without the cluster it is the last), and
// the warp that completes that count issues the slab SLOTS after the
// released one into the slot: it arms the full barrier of every block the
// copy lands in (mbarrier.arrive.expect_tx, the partner's through mapa)
// and issues the copy. So no thread waits for a slot: a slab is issued as
// soon as the last of its slot's readers lets it go (under MCAST a slab
// later: ring_free says why), and the ring holds SLOTS slabs ahead of the
// slowest reader. Designs the card ruled out on the way (NVIDIA H100):
// a consumer thread that issued the copies and waited for the slot two
// slabs back, or polled for free slots, put the copies on a warpgroup's
// path and coupled the warpgroups and the cluster's blocks; a remote
// release at cluster scope (.release.cluster / .acq_rel.cluster) cost
// more than the multicast saved, and waiting for the remote count's
// return still did. The slab sequence is W's again every step, so the
// copies run ahead across step and tile boundaries and the ring never
// drains at one.
//
// - Chain, K 512: 4 output chunks of 128 columns x 8 K slabs of 64 (16 KiB
//   a slab, 32 a step). A stays in registers (m64n128k16, A from
//   registers). A step cannot overwrite A until its last chunk is done, so
//   chunks 0-2 are written as bf16 into the warpgroup's stage tile, 64 x
//   (384 + 8) bf16 (50,176 B; each thread stores and reloads only its own
//   fragment places, so no barrier, and the 392-element row keeps a warp's
//   stores on 32 banks), and chunk 3 goes straight into A's last 8 K
//   slabs; then A's first 24 are reloaded from the stage. Shared memory:
//   1,024 alignment + 7 slots x 16,384 + 2 x 50,176 + 7 x 16 bytes of a
//   slot's barrier and two counts = 216,176 of 232,448 (an eighth slot
//   would make 232,576).
// - Pair, 384 x 192: slabs of 64 K x 192 columns (24 KiB). w1 is 6 slabs;
//   w2 is 3 K slabs x 2 halves of 192 output columns: 12 a step. Product 1
//   is x @ w1 into 96 registers, rounded to bf16 mid in registers; product
//   2 runs mid @ w2 a half at a time (m64n192k16), the first half's packed
//   output held in x's first 12 K slabs (x is dead by then) while the
//   second runs; together they are the next x. No stage; 8 slots: 1,024 +
//   8 x 24,576 + 8 x 16 = 197,760 B.
// - The staged variants stay on chain_kernel: their stage, the chain's 3
//   copies and the pair's 2 side by side, takes 64 x (3 x 512 + 8) x 2 =
//   197,632 B and 64 x (2 x 384 + 8) x 2 = 99,328 B a warpgroup; two
//   warpgroups' stages leave no room for a ring of even 2 slots.
// - MCAST false (served): each block walks 128-row tiles, persistent over
//   as many blocks as can be resident (one an SM), its own warps refilling
//   its ring.
// - MCAST (design="multicast", never served): the grid is clusters of 2
//   blocks. Each slab is multicast to both (cp.async.bulk ...
//   multicast::cluster, CTA mask 0b11) by whichever warp of the two
//   blocks released its slot last; each block's full barrier expects the
//   whole slab's bytes. The rank-0 block's thread 0 issues the first
//   SLOTS slabs. A cluster barrier follows the barriers' init and precedes
//   the exit, so that no block exits while its partner can still write
//   its shared memory, count on its counters or arm its barriers. The
//   cluster walks 256-row cluster tiles (rank r takes rows 128 r..),
//   persistent over as many clusters as can be resident
//   (cudaOccupancyMaxActiveClusters). A block whose rows all lie past M
//   (the last cluster tile, or M <= 128) runs the ring in step on zero
//   rows and stores nothing: otherwise the cluster hangs.
// - No branch on the warpgroup surrounds a wgmma (ptxas serialises them);
//   every input of a slab's wgmmas (A, the descriptors, the accumulators)
//   is defined before its fence. Every product sums in float32 from zeroed
//   accumulators over the same slabs in the same order wherever its row
//   lies, and rounds to bf16 (RN).

constexpr int RING_CONSUMER_WARPS = 8;
constexpr int RING_THREADS = 2 * WG_THREADS;         // 256
constexpr int RING_MAX_SLOTS = 8;

// The ring kernel's shape at (K, N, PAIR): a slab's columns (the wgmma's N)
// and bytes, slabs a step, the stage's row (bf16) and bytes a warpgroup,
// the ring's slots and the block's dynamic shared bytes.
template <int K, int N, bool PAIR>
struct RingShape {
  static_assert(PAIR ? K % 64 == 0 && N % 64 == 0 && K % N == 0 && N <= 256
                     : K % 128 == 0 && K > 128,
                "ring shape");
  static constexpr int COLS = PAIR ? N : 128;
  static constexpr int SLAB = COLS * 128;
  static constexpr int STEP = PAIR ? K / 64 + (N / 64) * (K / N) : (K / 128) * (K / 64);
  static constexpr int LDS = PAIR ? 0 : K - 128 + PAD;
  static constexpr int STAGE = 2 * WG_ROWS * LDS;
  static constexpr long long FIT = (SMEM_LIMIT - 1024 - 2LL * STAGE) / (SLAB + 16);
  static constexpr int SLOTS = FIT < RING_MAX_SLOTS ? (int)FIT : RING_MAX_SLOTS;
  static constexpr long long SMEM = 1024 + (long long)SLOTS * SLAB + 2LL * STAGE + 16LL * SLOTS;
  static_assert(SLOTS >= 2 && SMEM <= SMEM_LIMIT, "ring fit");
};

struct RingArgs {
  const bf16* x;
  bf16* out;
  const unsigned char* w;   // one step's slabs in order (pack_wgmma_slabs)
  int m, repeat;
};

// The ring as a thread sees it: the slots, full barriers and the block's
// counts of the slots (shared::cta addresses); under MCAST the cluster's
// counts (in the rank-0 block) and the partner's full barriers
// (shared::cluster addresses); the slot of the next slab to consume and
// its phase; the slab stream; and, for the next slab to be released, the
// place in the step of the slab its release refills the slot with and
// how many slabs are still to be issued after that one.
struct RingState {
  uint32_t slots, full, cnt, ccnt, pfull;
  int slot;
  uint32_t phase;
  const unsigned char* w;
  int src;
  long long left;
  uint32_t pend;      // MCAST, lane 0: the cluster count the last release read
};

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

// Waits for the phase of parity `parity` of the mbarrier at `bar`; a wait of
// 2^33 clocks (seconds) traps, so that a fault in the ring's bookkeeping
// ends the launch with an error instead of hanging.
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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of the cluster's blocks, released and acquired at cluster
// scope
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the shared::cluster address of `addr` in the block of cluster rank `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Slab `src` of the stream into `slot`: the full barrier of every block it
// lands in armed with its bytes, then one bulk copy (under MCAST to both
// blocks of the cluster).
template <class S, bool MCAST>
__device__ __forceinline__ void ring_fill(const RingState& r, int slot, int src) {
  const uint32_t bar = r.full + 8 * slot;
  const uint32_t dst = r.slots + (uint32_t)slot * S::SLAB;
  const unsigned char* from = r.w + (size_t)src * S::SLAB;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(S::SLAB) : "memory");
  if constexpr (MCAST) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cluster.b64 _, [%0], %1;\n"
                 ::"r"(r.pfull + 8 * slot), "r"(S::SLAB) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
                 ::"r"(dst), "l"(from), "r"(S::SLAB), "r"(bar), "h"((unsigned short)3)
                 : "memory");
  } else {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 ::"r"(dst), "l"(from), "r"(S::SLAB), "r"(bar) : "memory");
  }
}

// This warp's wgmmas on the slab in `slot` have completed. Lane 0 counts it
// in its block; the warp that completes the block's count refills the slot
// with the slab SLOTS later or, under MCAST, counts the block in the
// cluster, and the warp that completes the cluster's count refills it.
// The cluster count is a remote atomic: its old value is read only at the
// warp's next release, one slab later, so that its round trip overlaps the
// products instead of holding the warpgroup (the slot released before this
// one is the one refilled then).
template <class S, bool MCAST>
__device__ __forceinline__ void ring_free(RingState& r, int slot, int lane) {
  if (lane == 0) {
    if constexpr (MCAST) {
      if (r.pend & 1) {
        const int before = slot == 0 ? S::SLOTS - 1 : slot - 1;
        if (r.left >= 0) ring_fill<S, MCAST>(r, before, r.src == 0 ? S::STEP - 1 : r.src - 1);
      }
      r.pend = 0;
    }
    uint32_t old;
    asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                 : "=r"(old) : "r"(r.cnt + 4 * slot) : "memory");
    const bool last = (old & (RING_CONSUMER_WARPS - 1)) == RING_CONSUMER_WARPS - 1;
    if constexpr (MCAST) {
      if (last)
        asm volatile("atom.relaxed.cluster.shared::cluster.add.u32 %0, [%1], 1;\n"
                     : "=r"(r.pend) : "r"(r.ccnt + 4 * slot) : "memory");
    } else {
      if (last && r.left > 0) ring_fill<S, MCAST>(r, slot, r.src);
    }
  }
  if (++r.src == S::STEP) r.src = 0;
  --r.left;
}

// acc = A @ B over K = 16 KS: the KS / 4 slabs of the ring from its current
// slot on, 64 K x S::COLS each. Per slab: its four wgmmas (A's K slabs
// 4j..4j+3), one commit, then wait_group 1: the slab before has then been
// read and is released. Fully unrolled; from zeroed accumulators.
template <class S, int KS, bool MCAST>
__device__ __forceinline__ void ring_product(float (&acc)[S::COLS / 2],
                                             const uint32_t (&a)[KS][4],
                                             RingState& r, int lane) {
#pragma unroll
  for (int i = 0; i < S::COLS / 2; ++i) acc[i] = 0.f;
  int prev = 0;
#pragma unroll
  for (int j = 0; j < KS / 4; ++j) {
    mbar_wait(r.full + 8 * r.slot, r.phase);
    // every input of the slab's wgmmas defined before the fence (ptxas C7513)
    uint64_t d[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      d[kk] = b_desc(r.slots + (uint32_t)r.slot * S::SLAB + 32 * kk);
      asm volatile("" : "+l"(d[kk])::"memory");
    }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<S::COLS>(acc, a[4 * j + kk], d[kk], 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (j > 0) ring_free<S, MCAST>(r, prev, lane);
    prev = r.slot;
    if (++r.slot == S::SLOTS) {
      r.slot = 0;
      r.phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  ring_free<S, MCAST>(r, prev, lane);
}

// One warp's 16 rows of the chain from row0 for `repeat` steps; `stage` is
// the warp's 16 rows of its warpgroup's stage tile (rows of S::LDS bf16).
template <class S, int K, bool MCAST>
__device__ __forceinline__ void ring_chain(const RingArgs& p, RingState& r,
                                           uint32_t stage, int row0, int lane) {
  constexpr int KS = K / 16, C = K / 128;
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[KS][4];
  rows_io<K, true>(a, p.x, nullptr, row0, p.m, lane);
  for (int step = 0; step < p.repeat; ++step) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float acc[64];
      ring_product<S, KS, MCAST>(acc, a, r, lane);
      // register q of slab s: row g + 8 (q & 1), columns 16 s + 8 (q >> 1)
      // + 2t (+1) of the chunk, from acc[8 s + 2 q], acc[8 s + 2 q + 1]
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t v = pack_bf16(acc[8 * s + 2 * q], acc[8 * s + 2 * q + 1]);
          if (c < C - 1)
            st_shared(stage + 2 * ((g + 8 * (q & 1)) * S::LDS + 128 * c + 16 * s +
                                   8 * (q >> 1) + 2 * t), v);
          else
            a[KS - 8 + s][q] = v;
        }
    }
#pragma unroll
    for (int s = 0; s < KS - 8; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[s][q] = ld_shared(stage + 2 * ((g + 8 * (q & 1)) * S::LDS + 16 * s +
                                         8 * (q >> 1) + 2 * t));
  }
  rows_io<K, false>(a, nullptr, p.out, row0, p.m, lane);
}

// One warp's 16 rows of the pair from row0 for `repeat` steps.
template <class S, int K, int N, bool MCAST>
__device__ __forceinline__ void ring_pair(const RingArgs& p, RingState& r,
                                          int row0, int lane) {
  constexpr int KS = K / 16, NS = N / 16;
  uint32_t a[KS][4];
  rows_io<K, true>(a, p.x, nullptr, row0, p.m, lane);
  for (int step = 0; step < p.repeat; ++step) {
    uint32_t mid[NS][4];
    {
      float acc[N / 2];
      ring_product<S, KS, MCAST>(acc, a, r, lane);
      to_operand<N>(mid, acc);
    }
    // x is dead: half h of the next x goes into its K slabs NS h..
#pragma unroll
    for (int h = 0; h < K / N; ++h) {
      float acc[N / 2];
      ring_product<S, NS, MCAST>(acc, mid, r, lane);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[h * NS + s][q] = pack_bf16(acc[8 * s + 2 * q], acc[8 * s + 2 * q + 1]);
    }
  }
  rows_io<K, false>(a, nullptr, p.out, row0, p.m, lane);
}

template <int K, int N, bool PAIR, bool MCAST>
__global__ void __launch_bounds__(RING_THREADS, 1) wg_ring_chain_kernel(RingArgs p) {
  using S = RingShape<K, N, PAIR>;
  constexpr int CL = MCAST ? 2 : 1;
  RingState r;
  r.slots = (smem_addr(smem) + 1023) & ~1023u;       // the swizzle's 1024-byte atoms
  const uint32_t stage0 = r.slots + S::SLOTS * S::SLAB;
  r.full = stage0 + 2 * S::STAGE;
  r.cnt = r.full + 8 * S::SLOTS;
  r.slot = 0;
  r.phase = 0;
  const uint32_t rank = MCAST ? cluster_rank() : 0;
  r.ccnt = MCAST ? mapa(r.cnt + 4 * S::SLOTS, 0) : 0;
  r.pfull = MCAST ? mapa(r.full, rank ^ 1u) : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::SLOTS; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(r.full + 8 * i) : "memory");
    }
    for (int i = 0; i < 2 * S::SLOTS; ++i) st_shared(r.cnt + 4 * i, 0u);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (MCAST) cluster_sync();
  else __syncthreads();
  // the blocks of a cluster walk the same cluster tiles of CL x 128 rows
  const int group = blockIdx.x / CL, groups = gridDim.x / CL;
  const int gtiles = (p.m + CL * 2 * WG_ROWS - 1) / (CL * 2 * WG_ROWS);
  const long long total = (group < gtiles ? (gtiles - 1 - group) / groups + 1 : 0) *
                          (long long)p.repeat * S::STEP;
  r.w = p.w;
  r.src = S::SLOTS % S::STEP;
  r.left = total - S::SLOTS;
  r.pend = 0;
  // the first SLOTS slabs (under MCAST the rank-0 block's, to both)
  if (threadIdx.x == 0 && rank == 0)
    for (int i = 0; i < S::SLOTS && i < total; ++i) ring_fill<S, MCAST>(r, i, i % S::STEP);
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x / WG_THREADS, warp = (threadIdx.x / 32) % 4;
  const uint32_t stage = stage0 + wg * S::STAGE + 2 * warp * 16 * S::LDS;
  for (int gt = group; gt < gtiles; gt += groups) {
    const int row0 = (gt * CL + (int)rank) * 2 * WG_ROWS + wg * WG_ROWS + warp * 16;
    if constexpr (PAIR) ring_pair<S, K, N, MCAST>(p, r, row0, lane);
    else ring_chain<S, K, MCAST>(p, r, stage, row0, lane);
  }
  if constexpr (MCAST) cluster_sync();
}

// The shapes the ring serves (unstaged): the chain at K 512, the pair at
// 384 x 192.
bool ring_shape(int k, int n, int pair) {
  return pair ? k == 384 && n == 192 : k == 512;
}

template <int K, int N, bool PAIR>
Plan ring_plan(bool mcast) {
  using S = RingShape<K, N, PAIR>;
  Plan p;
  p.path = 2;
  p.wgmma = 1;
  p.w_smem = 0;
  p.kmax = 0;
  p.copies = 0;
  p.ldc = S::LDS;
  p.warps = RING_CONSUMER_WARPS;
  p.threads = RING_THREADS;
  p.slots = S::SLOTS;
  p.cluster = mcast ? 2 : 1;
  p.cols = S::COLS;
  p.smem = S::SMEM;
  return p;
}

// The launch of the ring kernel at M rows: its dynamic shared memory set,
// the cluster dimension under MCAST, and the grid persistent over as many
// groups (clusters, or blocks) as can be resident at once.
template <int K, int N, bool PAIR, bool MCAST>
cudaError_t ring_config(int m, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                        int& groups) {
  void (*kernel)(RingArgs) = wg_ring_chain_kernel<K, N, PAIR, MCAST>;
  using S = RingShape<K, N, PAIR>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (e != cudaSuccess) return e;
  constexpr int CL = MCAST ? 2 : 1;
  const int gtiles = (m + CL * 2 * WG_ROWS - 1) / (CL * 2 * WG_ROWS);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(CL * gtiles);
  cfg.blockDim = dim3(RING_THREADS);
  cfg.dynamicSmemBytes = (size_t)S::SMEM;
  cfg.attrs = attr;
  cfg.numAttrs = MCAST ? 1 : 0;
  groups = 0;
  if constexpr (MCAST) {
    if ((e = cudaOccupancyMaxActiveClusters(&groups, kernel, &cfg)) != cudaSuccess)
      return e;
  } else {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&groups, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return e;
  }
  if (groups < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(CL * (groups < gtiles ? groups : gtiles));
  return cudaSuccess;
}

template <int K, int N, bool PAIR, bool MCAST>
int launch_ring(const Args& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int groups = 0;
  cudaError_t e = ring_config<K, N, PAIR, MCAST>(a.m, cfg, attr, groups);
  if (e != cudaSuccess) return (int)e;
  cfg.stream = stream;
  RingArgs r;
  r.x = a.x;
  r.out = a.out;
  r.w = reinterpret_cast<const unsigned char*>(a.w[0]);
  r.m = a.m;
  r.repeat = a.repeat;
  if ((e = cudaLaunchKernelEx(&cfg, wg_ring_chain_kernel<K, N, PAIR, MCAST>, r)) !=
      cudaSuccess)
    return (int)e;
  return (int)cudaGetLastError();
}

template <int K, int N, bool PAIR, bool MCAST>
int ring_groups(int m) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int groups = 0;
  const cudaError_t e = ring_config<K, N, PAIR, MCAST>(m, cfg, attr, groups);
  return e == cudaSuccess ? (int)cfg.gridDim.x / (MCAST ? 2 : 1) : -(int)e;
}

int launch_ring_plan(const Args& a, const Plan& p, cudaStream_t st) {
  const bool mc = p.cluster == 2;
  if (a.pair)
    return mc ? launch_ring<384, 192, true, true>(a, st)
              : launch_ring<384, 192, true, false>(a, st);
  return mc ? launch_ring<512, 512, false, true>(a, st)
            : launch_ring<512, 512, false, false>(a, st);
}

// design MMA: chain_kernel. Else the ring for the unstaged chain at K 512
// and the unstaged 384 x 192 pair (weights of 512 and 288 KB; their staged
// variants take chain_kernel, the ring section says why); else the wgmma
// path where an instance exists and its weights (and, staged, at least one
// warpgroup's stage) fit shared memory; else chain_kernel.
Plan make_plan(int k, int n, int pair, int stage, int design) {
  if (design == MMA) return make_mma_plan(k, n, pair, stage);
  if (!stage && ring_shape(k, n, pair))
    return pair ? ring_plan<384, 192, true>(design == MULTICAST)
                : ring_plan<512, 512, false>(design == MULTICAST);
  const WgInstance* w = find_instance(k, n, pair);
  if (!w) return make_mma_plan(k, n, pair, stage);
  Plan p;
  p.wgmma = 1;
  p.path = 1;
  p.slots = 0;
  p.cluster = 1;
  p.cols = 0;
  p.w_smem = 1;
  p.kmax = 0;
  p.copies = stage ? (pair ? 2 : 3) : 0;
  const int width = pair && n > k ? n : k;
  p.ldc = stage ? p.copies * width + PAD : 0;
  const long long fixed = 1024 + image_bytes(k, pair ? n : k) +
                          (pair ? image_bytes(n, k) : 0) + 16;
  const long long per_wg = 2LL * WG_ROWS * p.ldc;
  long long nwg = w->nwg;
  if (per_wg && (SMEM_LIMIT - fixed) / per_wg < nwg) nwg = (SMEM_LIMIT - fixed) / per_wg;
  if (fixed > SMEM_LIMIT || nwg < 1) return make_mma_plan(k, n, pair, stage);
  p.warps = (int)nwg * 4;
  p.threads = p.warps * 32;
  p.smem = fixed + nwg * per_wg;
  return p;
}

int launch_wgmma(const Args& a, const Plan& p, cudaStream_t stream) {
  const WgInstance* w = find_instance(a.k, a.n, a.pair);
  cudaError_t e = cudaFuncSetAttribute(
      w->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)e;
  const int nwg = p.warps / 4;
  const int groups = ((a.m + WG_ROWS - 1) / WG_ROWS + nwg - 1) / nwg;
  WgArgs g;
  g.x = a.x;
  g.out = a.out;
  g.w[0] = a.w[0];
  g.w[1] = a.w[1];
  g.m = a.m;
  g.repeat = a.repeat;
  g.copies = p.copies;
  g.ldc = p.ldc;
  w->kernel<<<groups < sms ? groups : sms, nwg * WG_THREADS, (size_t)p.smem,
              stream>>>(g);
  return (int)cudaGetLastError();
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

bool valid(int m, int k, int n, int pair, int repeat, int stage, int design) {
  const auto dim_ok = [](int d) { return d >= 16 && d <= MAX_WIDTH && d % 16 == 0; };
  return m >= 1 && repeat >= 0 && dim_ok(k) && (!pair || dim_ok(n)) &&
         (stage == 0 || stage == 1) && design >= SERVED && design <= MMA &&
         (design != MULTICAST || (!stage && ring_shape(k, n, pair)));
}

}  // namespace

// x, out: (M, K) bf16, contiguous, 16-byte aligned. w1: the chain's W (K, K)
// or the pair's w1 (K, N); w2: the pair's w2 (N, K), unused by the chain;
// both packed as the plan's path takes them (ops/matmul_chain.py:
// pack_fragments for mma.sync, pack_wgmma for wg_chain_kernel; for the
// ring, w1 is one step's slabs, pack_wgmma_slabs, and w2 is unused). pair:
// 0 chain, 1 pair; stage: 0 or 1; design: 0 served, 1 multicast (the ring
// shapes, unstaged), 2 mma. K and N are multiples of 16 in [16, 512].
// Returns the CUDA error code of the launch (0 = success).
extern "C" int s2sr_matmul_chain_forward(const void* x, void* out,
                                         const void* w1, const void* w2, int M,
                                         int K, int N, int repeat, int pair,
                                         int stage, int design, void* stream) {
  if (!valid(M, K, N, pair, repeat, stage, design)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(K, N, pair, stage, design);
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
  if (p.path == 2) return launch_ring_plan(a, p, st);
  if (p.path == 1) return launch_wgmma(a, p, st);
  switch (p.kmax) {
    case 128: return launch_kmax<128>(a, p, st);
    case 256: return launch_kmax<256>(a, p, st);
    default: return launch_kmax<512>(a, p, st);
  }
}

// The launch plan of a (K, N, pair, stage, design): what = 0 rows per
// block, 1 dynamic shared-memory bytes per block, 2 whether the weights sit
// in shared memory (1) or not (0), 3 warps per block (the ring: its
// consumer warps), 4 the register class of A (KMAX; 0 on the wgmma paths),
// 5 copies of each product's output stored, 6 whether B is packed for
// wgmma (1) or mma.sync (0), 7 the path (0 chain_kernel, 1 wg_chain_kernel,
// 2 wg_ring_chain_kernel), 8 threads per block, 9 slots of the B ring, 10
// blocks a cluster, 11 columns of a B slab; -1 for an unknown field or an
// invalid call.
extern "C" long long s2sr_matmul_chain_query(int K, int N, int pair, int stage,
                                             int design, int what) {
  if (!valid(1, K, N, pair, 0, stage, design)) return -1;
  const Plan p = make_plan(K, N, pair, stage, design);
  switch (what) {
    case 0: return (long long)p.warps * WARP_ROWS;
    case 1: return p.smem;
    case 2: return p.w_smem;
    case 3: return p.warps;
    case 4: return p.kmax;
    case 5: return p.copies;
    case 6: return p.wgmma;
    case 7: return p.path;
    case 8: return p.threads;
    case 9: return p.slots;
    case 10: return p.cluster;
    case 11: return p.cols;
  }
  return -1;
}

// The groups (blocks for design 0, clusters of 2 for design 1) the ring
// kernel of the pair (1) or the chain (0) runs at M rows: as many as can be
// resident at once, at most one a tile; the negative CUDA error code if
// the query fails. Needs the device.
extern "C" int s2sr_matmul_chain_ring_groups(int pair, int design, int M) {
  if (M < 1 || (design != SERVED && design != MULTICAST)) return -(int)cudaErrorInvalidValue;
  const bool mc = design == MULTICAST;
  if (pair)
    return mc ? ring_groups<384, 192, true, true>(M) : ring_groups<384, 192, true, false>(M);
  return mc ? ring_groups<512, 512, false, true>(M) : ring_groups<512, 512, false, false>(M);
}

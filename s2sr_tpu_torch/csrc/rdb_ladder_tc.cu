// RDB ablation ladder, rungs v1, v2 and v3 in bfloat16 on the tensor cores
// (wgmma), for NVIDIA Hopper (sm_90a).
//
// Replaces, for bfloat16, the TPU kernels
// s2sr_tpu/ops/pallas/fused_rdb.py::rdb_pallas (rung v1), ::rdb_pallas_v2
// (rung v2) and ::rdb_pallas_v3 (rung v3); csrc/rdb_ladder.cu keeps their
// float32 instances on the CUDA cores. Each computes, in one launch per
// block of the network, the function of
// ops/rdb_ladder.py::rdb_v1_reference / rdb_v2_reference / rdb_v3_reference
// and rounds where they round:
//
// - v3, the delta form with the 9-tap im2col staged: the conv of each source
//   (x, then x1..x4) is one product (pixels, 9 Cin) x (9 Cin, N) that emits
//   its contributions to every later stage, [c5|c4|..|c_{j+1}], N = 192,
//   160, 128, 96, 64. Every product output and every slot add rounds to
//   bf16; bias, LeakyReLU and the tail 0.2 (x5 + b5) + x run in float32.
// - v2, the same delta form with the TPU kernel's 3-tap staging: the three
//   dx taps of a source side by side as K (3 Cin per position) in one
//   staged band, its three dy parts read from that band as row-shifted
//   views. One float32 accumulator runs over the three dy parts: the
//   plain version's float32 sum of three products, in another order.
// - v1, the K-packed concat form: the conv of x emits [p1|p2|p3|p4|p5]
//   (N = 192; p1..p4 rounded to bf16, p5 kept in float32), then each stage
//   k = 2..5 convolves the growth buffer, x1..x4 stacked in 128 lanes,
//   against weights whose rows for x_k..x4 are zero (N = 32, 64 for k = 5).
//   The zero rows are staged and executed, as in the TPU kernel: that is
//   the rung's own ablation (executed / useful is reported).
//
// What bounds the function: operations (479,232 useful FLOP per pixel
// against 256 bytes moved per pixel). What bounds this design: the bytes
// each step streams from L2 into shared memory (at N 192 a step stages
// 16 KB of x's taps and 24 KB of B for 1.6 M multiply-adds), and for v1's
// narrow growth products the staging itself. The design:
//
// - Each thread block owns one TILE x TILE output tile of one image and two
//   warpgroups (256 threads). The stage values (the delta form's slots
//   c1..c5, v1's p_k then x_k, and v1's float32 p5) live in shared memory,
//   pixel-major, over the region R_k where stage k is needed (side
//   TILE + 2 (5 - k)), read and written by plain accesses.
// - A product runs in passes of 128 positions, 64 per warpgroup (one
//   wgmma M tile), and walks K in steps of up to 64: the warpgroup's A is
//   64 positions x 64 K values, B's slab N x 64, both in wgmma's K-major
//   canonical layout with the 128-byte swizzle (row r of 128 bytes, 16-byte
//   chunk c stored at chunk c ^ (r % 8), 8-row groups 1024 bytes apart) and
//   read by descriptor. B's slab comes from the wrapper's packed image
//   (ops/rdb_ladder.py::pack_tc_images) by cp.async through a ring of
//   stages, staged one to six steps ahead of the wgmmas, across the passes
//   of a product. Both warpgroups issue in every step, also over an M tile
//   past the region: a branch on the warpgroup would serialise the wgmmas.
// - v1 and v3 stage A in the ring beside B, per step: a slab of x is one
//   tap's 64 channels, copied from device memory by cp.async (zero-filled
//   outside the image); a slab of x_j (v3) is two taps of 32 channels, and
//   of v1's growth buffer one tap's 64 lanes, copied from the slots
//   through registers. The ring of 81,920 bytes holds two stages of A and
//   B at N 192 down to four at N 32.
// - v2 stages A once per pass and dx group into a band outside the ring:
//   positions are laid out at a row pitch P (a multiple of 8 positions, at
//   least the region's side), position q = qy P + qx one 128-byte row, and
//   the band holds the pass's 128 rows and the 2 P below them. The dy part
//   of a step reads the band from row dy P: its descriptor start moves by
//   dy P 128 bytes, whole 1024-byte swizzle atoms, so the base-offset field
//   stays 0. x's groups are its three dx taps (64 K each), copied from
//   device memory once per pass and group; x_j's are [dx 0 | dx 1] (64 K)
//   and [dx 2] (32 K, 2 of 4 k16 steps, only its half of B copied), from
//   the slots. The positions of a row past the region's side are computed
//   and dropped. The ring holds B alone (61,440 bytes: two stages at N 192
//   up to seven at N 64) and the band 22,528 bytes.
// - Every column is computed for every position of the product's region;
//   the epilogue keeps each column where its slot's region holds the pixel.
// - Weights are read from L2 once per pass (not resident: x's B alone is
//   221,184 bytes); chip_smoke.py's ladder_l2_bytes counts every byte a
//   launch streams.
//
// Tiles: v3 and v2 16 x 16 (slots 146,944 B), v1 14 x 14 (slots and p5
// 143,872 B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NF = 64;                  // features
constexpr int G = 32;                   // growth channels
constexpr int WGS = 2;                  // warpgroups per block
constexpr int THREADS = 128 * WGS;
constexpr int PASS = 64 * WGS;          // positions per pass
constexpr int A_SLAB = 64 * 128;        // bytes: one warpgroup's A slab
constexpr int RING = 2 * (WGS * A_SLAB + 192 * 128);   // two stages at N 192
constexpr long long SMEM_LIMIT = 232448;

__host__ __device__ constexpr int side(int tile, int k) { return tile + 2 * (5 - k); }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The ring's stages for a product of N columns: [A (A_BYTES) | B] rounded
// up to the swizzle's 1024-byte atoms, as many as BYTES holds (v1, v3: A
// of both warpgroups, 2 stages for N 96..192, 3 for 64, 4 for 32; v2: B
// alone, 2 for N 192 up to 7 for 64); the stages run NBUF - 1 steps ahead
// of the wgmmas.
template <int N, int A_BYTES, int BYTES>
struct Ring {
  static constexpr int STAGE = cdiv(A_BYTES + N * 128, 1024) * 1024;
  static constexpr int NBUF = BYTES / STAGE;
  static constexpr int A = A_BYTES;
  static_assert(NBUF >= 2, "the ring holds two stages");
};
// columns of the delta form's source j product, [c5 (64) | c4 | ... | c_{j+1}]
__host__ __device__ constexpr int src_n(int j) { return NF + G * (4 - j); }

// --- the rungs' tilings ----------------------------------------------------

// byte offset, after the ring (and v2's band), of slot k (1..5; bf16,
// pixel-major, 32 channels, 64 for k = 5) over R_k; slot_off(tile, 6) ends
// the slots
__host__ __device__ constexpr int slot_off(int tile, int k) {
  int off = 0;
  for (int i = 1; i < k; ++i) off += (i < 5 ? G : NF) * 2 * side(tile, i) * side(tile, i);
  return off;
}

// Each rung: TILE; RING_BYTES of ring; BAND bytes of band (v2); VALUES
// bytes of stage values; per product j (source x, then x_j or v1's stage
// j + 1) its region's side, the M rows it runs (positions), the K values
// executed per position and its N.
struct V3 {
  static constexpr int TILE = 16;
  static constexpr int RING_BYTES = RING;
  static constexpr int BAND = 0;
  static constexpr int VALUES = slot_off(TILE, 6);
  // K values executed per pixel of source j: 9 taps of Cin
  static constexpr int k_exec(int j) { return 9 * (j == 0 ? NF : G); }
  static constexpr int region(int j) { return side(TILE, j + 1); }
  static constexpr int rows(int j) { return region(j) * region(j); }
  static constexpr int n(int j) { return src_n(j); }
};

struct V2 {
  static constexpr int TILE = 16;
  static constexpr int RING_BYTES = 61440;
  // (host and device: the kernel reads them too)
  __host__ __device__ static constexpr int region(int j) { return side(TILE, j + 1); }
  // the band's row pitch over product j's region: 24, 24, 24, 24, 16
  __host__ __device__ static constexpr int pitch(int j) {
    return cdiv(region(j), 8) * 8;
  }
  // a pass's 128 rows and the 2 P rows its dy parts reach below them
  static constexpr int BAND = (PASS + 2 * 24) * 128;
  static constexpr int VALUES = slot_off(TILE, 6);
  // position qy P + qx for qy, qx < region: the last is (S - 1) P + S - 1
  __host__ __device__ static constexpr int rows(int j) {
    return (region(j) - 1) * pitch(j) + region(j);
  }
  // x: 3 dy x 3 dx x 64; x_j: 3 dy x (64 + 32)
  static constexpr int k_exec(int j) { return j == 0 ? 9 * NF : 3 * 3 * G; }
  static constexpr int n(int j) { return src_n(j); }
};

struct V1 {
  static constexpr int TILE = 14;
  static constexpr int RING_BYTES = RING;
  static constexpr int BAND = 0;
  // slots 1..4 (p_k, then x_k), then p5 in float32 over the tile
  static constexpr int P5 = slot_off(TILE, 5);
  static constexpr int VALUES = P5 + NF * 4 * TILE * TILE;
  // stage k = 1..5: x's 9 x 64 taps, else the growth buffer's 9 x 128
  static constexpr int k_exec(int j) { return j == 0 ? 9 * NF : 9 * 4 * G; }
  static constexpr int region(int j) { return side(TILE, j + 1); }
  static constexpr int rows(int j) { return region(j) * region(j); }
  static constexpr int n(int j) { return j == 0 ? NF + 4 * G : (j < 4 ? G : NF); }
};

template <typename R>
struct Cfg {
  static constexpr int TILE = R::TILE;
  static constexpr long long SMEM =
      1024 + R::RING_BYTES + R::BAND + R::VALUES;   // + alignment
  static_assert(SMEM <= SMEM_LIMIT, "shared memory over the block limit");
  // Multiply-adds one block executes for its tile: each product over its
  // rows in passes of PASS positions (both warpgroups issue in every
  // pass), all N columns, k_exec K values.
  static constexpr long long macs() {
    long long m = 0;
    for (int j = 0; j < 5; ++j)
      m += (long long)cdiv(R::rows(j), PASS) * PASS * R::k_exec(j) * R::n(j);
    return m;
  }
};

// --- wgmma -----------------------------------------------------------------

// wgmma.mma_async m64nNk16, bf16 in, float32 accumulators, A and B from
// shared memory by descriptor: d (N/2 floats a thread) = A B (+ d if scale_d)
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<160>(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the threads' shared-memory writes, visible to the wgmmas after the barrier
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major, 128-byte-swizzled operand at shared address
// `addr`: 8-row groups 1024 bytes apart (SBO 64), the leading offset unused
// by this layout (1), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

// byte offset of 16-byte chunk c of row r in a swizzled slab
__host__ __device__ constexpr uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest `pending` groups of this thread's copies have landed
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ uint32_t pack(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// v rounded to bf16, back in float32
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : __fmul_rn(v, 0.2f);
}

struct Args {
  const bf16* x;
  bf16* out;
  const bf16* img[5];     // the five packed B images (pack_tc_images)
  const float* b14;       // 128
  const float* b5;        // 64
  int H, W;
};

// Block-wide context: image, tile origin, shared addresses.
struct Ctx {
  uint32_t ring;          // 1024-aligned: the ring's stages (Ring<...>)
  uint32_t band;          // 1024-aligned, after the ring: v2's band
  uint32_t vals;          // the stage values after the ring and the band
  unsigned char* base;    // the ring's generic address, for plain accesses
  int b, oy0, ox0;
};

template <typename R>
__device__ __forceinline__ Ctx make_ctx(unsigned char* smem) {
  Ctx c;
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  c.ring = (raw + 1023) & ~1023u;
  c.band = c.ring + R::RING_BYTES;
  c.vals = c.band + R::BAND;
  c.base = smem + (c.ring - raw);
  c.b = blockIdx.z;
  c.oy0 = blockIdx.y * R::TILE;
  c.ox0 = blockIdx.x * R::TILE;
  return c;
}

// The value of type T at shared address `addr`, by a plain C++ access, so
// that the compiler may overlap the loads of an epilogue or a stage.
template <typename T>
__device__ __forceinline__ T& sh(const Ctx& c, uint32_t addr) {
  return *reinterpret_cast<T*>(c.base + (addr - c.ring));
}

// B slab s of an image with N columns to shared address b0: N rows of 128
// bytes, already swizzled by the packer, one 16-byte cp.async per chunk;
// `half`: only the logical chunks 0..3 (K 0..31), which a step of 2 k16
// steps reads.
template <int N>
__device__ __forceinline__ void stage_b(uint32_t b0, const bf16* img, int s,
                                        bool half = false) {
  const char* src = reinterpret_cast<const char*>(img) + (size_t)s * N * 128;
  for (int i = threadIdx.x; i < N * 8; i += THREADS)
    if (!half || ((i ^ (i >> 3)) & 7) < 4) cp_async16(b0 + 16 * i, src + 16 * i, true);
}

// shared address of pass pixel p's chunk ch in the A slabs at a0
__device__ __forceinline__ uint32_t a_chunk(uint32_t a0, int p, int ch) {
  return a0 + (p >> 6) * A_SLAB + swz(p & 63, ch);
}

// A slab `tap` of source x: pass pixel p (0..127, warpgroup p / 64, row
// p % 64) is region pixel i = pass * PASS + p of R1 (side S, raster order),
// whose 3x3 window starts at image pixel (oy0 - 5 + qy, ox0 - 5 + qx); row
// p holds the 64 channels of its tap, chunk c at swz(row, c). Zero outside
// the image and past the region.
template <int S>
__device__ __forceinline__ void stage_x(const Ctx& c, const Args& a, uint32_t a0,
                                        int pass, int tap) {
  const int dy = tap / 3, dx = tap % 3;
  for (int e = threadIdx.x; e < PASS * 8; e += THREADS) {
    const int p = e >> 3, ch = e & 7;
    const int i = pass * PASS + p;
    const int qy = i / S, qx = i % S;
    const int gy = c.oy0 - 5 + qy + dy, gx = c.ox0 - 5 + qx + dx;
    const bool in = i < S * S && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    const bf16* src = in ? a.x + (((size_t)c.b * a.H + gy) * a.W + gx) * NF + 8 * ch
                         : a.x;
    cp_async16(a_chunk(a0, p, ch), src, in);
  }
}

// The product of one source: passes of PASS positions (npix in all) over
// NSLAB K steps (KS(s) k16 steps of step s), walked as one sequence of
// steps through the ring Rg, each step's copies one cp.async group: step
// it + NBUF - 1 is staged while step it's wgmmas run, across the passes
// too; after a pass's last step, epi(pass, acc) on each warpgroup whose M
// tile holds positions. stage(base, b0, pass, s) stages step s into the
// ring stage at base (A at base, WG 1's at base + A_SLAB; B at b0).
// a_at(base, pass, s) is WG 0's A for the step (WG 1's + A_SLAB). When
// band(pass, s) returns true it has just staged A outside the ring: every
// copy lands and shows to the wgmmas before the step's.
template <int N, int NSLAB, typename Rg, typename KS, typename StageF,
          typename AAt, typename Band, typename Epi>
__device__ __forceinline__ void product(const Ctx& c, int npix, KS ks,
                                        StageF stage, AAt a_at, Band band,
                                        Epi epi) {
  const int wg = threadIdx.x >> 7;
  const int steps = cdiv(npix, PASS) * NSLAB;
  auto stage_step = [&](int st) {
    if (st < steps) {
      const int pass = st / NSLAB;
      const uint32_t base = c.ring + (st % Rg::NBUF) * Rg::STAGE;
      stage(base, base + Rg::A, pass, st - pass * NSLAB);
    }
    cp_async_commit();                    // empty past the end: counts stay
  };
  float acc[N / 2];
  for (int st = 0; st < Rg::NBUF - 1; ++st) stage_step(st);
  cp_async_wait<Rg::NBUF - 2>();
  fence_async_shared();
  __syncthreads();
#pragma unroll 1
  for (int it = 0; it < steps; ++it) {
    const int pass = it / NSLAB, s = it - pass * NSLAB;
    const uint32_t base = c.ring + (it % Rg::NBUF) * Rg::STAGE;
    if (band(pass, s)) {                  // the wgmmas before have ended
      cp_async_commit();
      cp_async_wait<0>();
      fence_async_shared();
      __syncthreads();
    }
    // both warpgroups issue, also over M tiles past the region (zero
    // rows): a branch on the warpgroup would serialise the wgmmas
    wgmma_fence();
    const uint32_t a0 = a_at(base, pass, s) + wg * A_SLAB, b0 = base + Rg::A;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < ks(s)) wgmma_ss<N>(acc, desc(a0 + 32 * kk), desc(b0 + 32 * kk),
                                  s > 0 || kk > 0);
    wgmma_commit();
    stage_step(it + Rg::NBUF - 1);
    cp_async_wait<Rg::NBUF - 2>();        // step it + 1 has landed
    wgmma_wait();
    fence_async_shared();
    __syncthreads();
    if (s == NSLAB - 1 && pass * PASS + wg * 64 < npix) epi(pass, acc);
  }
  __syncthreads();
}

// v1's and v3's steps: A and B staged in the ring, A first
template <int N>
using SlabRing = Ring<N, WGS * A_SLAB, RING>;
struct AInRing {
  __device__ __forceinline__ uint32_t operator()(uint32_t base, int, int) const { return base; }
};
struct NoBand {
  __device__ __forceinline__ bool operator()(int, int) const { return false; }
};

// This thread's two accumulator rows: M-tile row 16 * warp + g + 8 h
// (h = 0, 1) holds, in registers 4 i + 2 h and 4 i + 2 h + 1, the columns
// 8 i + 2 t and 8 i + 2 t + 1 (n8 block i). Region pixel of row h of the
// warpgroup's M tile in this pass, and the thread's first column 2 t.
__device__ __forceinline__ int acc_pixel(int pass, int h) {
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  return pass * PASS + (threadIdx.x >> 7) * 64 + 16 * warp + g + 8 * h;
}
__device__ __forceinline__ int acc_col() { return 2 * (threadIdx.x & 3); }

// x_K = lrelu(c + b_K) in place of slot K (32 channels over R_K), zero
// outside the image.
template <int TILE, int K>
__device__ __forceinline__ void activate(const Ctx& c, const Args& a) {
  constexpr int S = side(TILE, K);
  const uint32_t slot = c.vals + slot_off(TILE, K);
  for (int e = threadIdx.x; e < S * S * (G / 2); e += THREADS) {
    const int p = e / (G / 2), ch = 2 * (e % (G / 2));
    const int gy = c.oy0 - (5 - K) + p / S, gx = c.ox0 - (5 - K) + p % S;
    const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    const float2 v = unpack(sh<uint32_t>(c, slot + 4 * e));
    const float y0 = lrelu(__fadd_rn(v.x, __ldg(a.b14 + (K - 1) * G + ch)));
    const float y1 = lrelu(__fadd_rn(v.y, __ldg(a.b14 + (K - 1) * G + ch + 1)));
    sh<uint32_t>(c, slot + 4 * e) = inside ? pack(y0, y1) : 0u;
  }
  __syncthreads();
}

// out = 0.2 (x5 + b5) + x at tile pixel (qy, qx), channels ch, ch + 1
__device__ __forceinline__ void store_out(const Ctx& c, const Args& a, int qy,
                                          int qx, int ch, float x50, float x51) {
  const int gy = c.oy0 + qy, gx = c.ox0 + qx;
  if (gy >= a.H || gx >= a.W) return;
  const size_t at = (((size_t)c.b * a.H + gy) * a.W + gx) * NF + ch;
  const float2 xin = unpack(*reinterpret_cast<const uint32_t*>(a.x + at));
  const float y0 = __fadd_rn(__fmul_rn(__fadd_rn(x50, __ldg(a.b5 + ch)), 0.2f), xin.x);
  const float y1 = __fadd_rn(__fmul_rn(__fadd_rn(x51, __ldg(a.b5 + ch + 1)), 0.2f), xin.y);
  *reinterpret_cast<uint32_t*>(a.out + at) = pack(y0, y1);
}

// --- the delta form (v3, v2) -------------------------------------------------

// Source J's product at pixel (qy, qx) of R_{J+1}, accumulator half h: its
// columns [c5 (64) | c4 | ... | c_{J+1}], each rounded to bf16, into slot k
// from column col0 where R_k holds the pixel (x: stored, x_1..x_3: added,
// rounded; x_4: the tail, out).
template <int TILE, int J, int N>
__device__ __forceinline__ void delta_update(const Ctx& c, const Args& a, int qy,
                                             int qx, int h, const float (&acc)[N / 2]) {
#pragma unroll
  for (int k = 5; k > J; --k) {
    const int col0 = k == 5 ? 0 : NF + G * (4 - k);
    const int chans = k == 5 ? NF : G;
    const int o = k - J - 1;              // R_k's corner in R_{J+1}
    const int sk = side(TILE, k);
    if (qy < o || qy >= o + sk || qx < o || qx >= o + sk) continue;
    const uint32_t at = c.vals + slot_off(TILE, k) +
        (((qy - o) * sk + qx - o) * chans + acc_col()) * 2;
#pragma unroll
    for (int nb = 0; nb < chans / 8; ++nb) {
      const int r = 4 * (col0 / 8 + nb) + 2 * h;
      const float r0 = rnd(acc[r]), r1 = rnd(acc[r + 1]);
      if constexpr (J == 0) {
        sh<uint32_t>(c, at + 16 * nb) = pack(r0, r1);
      } else {
        const float2 old = unpack(sh<uint32_t>(c, at + 16 * nb));
        if constexpr (J < 4)
          sh<uint32_t>(c, at + 16 * nb) = pack(old.x + r0, old.y + r1);
        else
          store_out(c, a, qy, qx, 8 * nb + acc_col(), rnd(old.x + r0),
                    rnd(old.y + r1));
      }
    }
  }
}

// --- v3: 9-tap staging --------------------------------------------------------

// Source J (0 = x, else x_J) over R_{J+1}, its slot updates, then x_{J+1}.
template <int J>
__device__ __forceinline__ void v3_source(const Ctx& c, const Args& a) {
  constexpr int TILE = V3::TILE;
  constexpr int S = side(TILE, J + 1);    // R_{J+1}
  constexpr int N = src_n(J);
  constexpr int NSLAB = J == 0 ? 9 : 5;
  const bf16* img = a.img[J];
  auto ks = [](int s) { return J > 0 && s == 4 ? 2 : 4; };
  auto stage = [&](uint32_t a0, uint32_t b0, int pass, int s) {
    if constexpr (J == 0) {
      stage_x<S>(c, a, a0, pass, s);
    } else {
      // taps 2s (chunks 0..3) and 2s + 1 (chunks 4..7) of x_J from slot J
      // over R_J (side S + 2); pixel (qy, qx) of R_{J+1} sits at
      // (qy + 1, qx + 1) there. Slab 4 holds tap 8 alone.
      const uint32_t src = c.vals + slot_off(TILE, J);
      for (int e = threadIdx.x; e < PASS * 8; e += THREADS) {
        const int p = e >> 3, ch = e & 7;
        const int tap = 2 * s + (ch >> 2);
        if (tap > 8) continue;
        const int i = pass * PASS + p;
        const int qy = i / S + tap / 3, qx = i % S + tap % 3;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (i < S * S) v = sh<uint4>(c, src + ((qy * (S + 2) + qx) * G + 8 * (ch & 3)) * 2);
        sh<uint4>(c, a_chunk(a0, p, ch)) = v;
      }
    }
    stage_b<N>(b0, img, s);
  };
  auto epi = [&](int pass, const float(&acc)[N / 2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = acc_pixel(pass, h);
      if (i < S * S) delta_update<TILE, J, N>(c, a, i / S, i % S, h, acc);
    }
  };
  product<N, NSLAB, SlabRing<N>>(c, S * S, ks, stage, AInRing(), NoBand(), epi);
  if constexpr (J < 4) activate<TILE, J + 1>(c, a);
}

__global__ void __launch_bounds__(THREADS, 1) v3_tc_kernel(Args a) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const Ctx c = make_ctx<V3>(tc_smem);
  v3_source<0>(c, a);
  v3_source<1>(c, a);
  v3_source<2>(c, a);
  v3_source<3>(c, a);
  v3_source<4>(c, a);
}

// --- v2: 3-tap staging, the dy parts from one band ---------------------------

// The band of x for one pass and dx tap: row r is position q = pass * PASS
// + r at pitch P (window row q / P, column q % P) and holds the 64 channels
// of window pixel (q / P, q % P + dx), i.e. image pixel (oy0 - 5 + q / P,
// ox0 - 5 + q % P + dx), copied by cp.async; zero outside the image and the
// window (side S + 2).
template <int S, int P>
__device__ __forceinline__ void band_x(const Ctx& c, const Args& a, int pass, int dx) {
  for (int e = threadIdx.x; e < (PASS + 2 * P) * 8; e += THREADS) {
    const int r = e >> 3, ch = e & 7;
    const int q = pass * PASS + r;
    const int wy = q / P, wx = q % P + dx;
    const int gy = c.oy0 - 5 + wy, gx = c.ox0 - 5 + wx;
    const bool in = wy < S + 2 && wx < S + 2 && gy >= 0 && gy < a.H && gx >= 0 &&
                    gx < a.W;
    const bf16* src = in ? a.x + (((size_t)c.b * a.H + gy) * a.W + gx) * NF + 8 * ch
                         : a.x;
    cp_async16(c.band + swz(r, ch), src, in);
  }
}

// The band of x_J (J >= 1) for one pass and group g, from slot J over R_J
// (side S + 2, where pixel (qy, qx) of R_{J+1} sits at (qy + 1, qx + 1)):
// row r, position q as above, holds for g = 0 the 32 channels of R_J pixel
// (q / P, q % P) in chunks 0..3 and of (q / P, q % P + 1) in chunks 4..7,
// for g = 1 those of (q / P, q % P + 2) in chunks 0..3 (4..7 are not read).
// Zero past R_J.
template <int J, int S, int P>
__device__ __forceinline__ void band_slots(const Ctx& c, int pass, int g) {
  const uint32_t src = c.vals + slot_off(V2::TILE, J);
  const int chans = g == 0 ? 8 : 4;
  for (int e = threadIdx.x; e < (PASS + 2 * P) * chans; e += THREADS) {
    const int r = g == 0 ? e >> 3 : e >> 2, ch = g == 0 ? e & 7 : e & 3;
    const int q = pass * PASS + r;
    const int wy = q / P, wx = q % P + 2 * g + (ch >> 2);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (wy < S + 2 && wx < S + 2)
      v = sh<uint4>(c, src + ((wy * (S + 2) + wx) * G + 8 * (ch & 3)) * 2);
    sh<uint4>(c, c.band + swz(r, ch)) = v;
  }
}

// Source J over R_{J+1} at pitch P: per pass, K groups (x: dx 0, 1, 2;
// x_J: [dx 0 | dx 1], [dx 2]), each staged into the band once and read by
// its three dy steps from band row dy P; B's slab for (dy, group) through
// the ring. Then x_{J+1}.
template <int J>
__device__ __forceinline__ void v2_source(const Ctx& c, const Args& a) {
  constexpr int TILE = V2::TILE;
  constexpr int S = V2::region(J);
  constexpr int P = V2::pitch(J);
  constexpr int N = src_n(J);
  constexpr int NSLAB = J == 0 ? 9 : 6;   // step s: group s / 3, dy s % 3
  const bf16* img = a.img[J];
  auto ks = [](int s) { return J > 0 && s >= 3 ? 2 : 4; };
  auto stage = [&](uint32_t, uint32_t b0, int, int s) {
    const int g = s / 3, dy = s % 3;
    // B's K order is v3's (dy, dx, cin) for x, and per dy [dx 0 | dx 1],
    // [dx 2 | zero] for x_J (pack_tc_images)
    if constexpr (J == 0)
      stage_b<N>(b0, img, 3 * dy + g);
    else
      stage_b<N>(b0, img, 2 * dy + g, g == 1);
  };
  auto a_at = [&](uint32_t, int, int s) { return c.band + (s % 3) * P * 128; };
  auto band = [&](int pass, int s) {
    if (s % 3) return false;
    if constexpr (J == 0)
      band_x<S, P>(c, a, pass, s / 3);
    else
      band_slots<J, S, P>(c, pass, s / 3);
    return true;
  };
  auto epi = [&](int pass, const float(&acc)[N / 2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = acc_pixel(pass, h);
      const int qy = i / P, qx = i % P;
      if (qy < S && qx < S) delta_update<TILE, J, N>(c, a, qy, qx, h, acc);
    }
  };
  static_assert((P * 128) % 1024 == 0, "a dy shift is whole swizzle atoms");
  static_assert(PASS + 2 * P <= V2::BAND / 128, "the band holds a pass");
  product<N, NSLAB, Ring<N, 0, V2::RING_BYTES>>(c, V2::rows(J), ks, stage, a_at,
                                                band, epi);
  if constexpr (J < 4) activate<TILE, J + 1>(c, a);
}

__global__ void __launch_bounds__(THREADS, 1) v2_tc_kernel(Args a) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const Ctx c = make_ctx<V2>(tc_smem);
  v2_source<0>(c, a);
  v2_source<1>(c, a);
  v2_source<2>(c, a);
  v2_source<3>(c, a);
  v2_source<4>(c, a);
}

// --- v1: the K-packed concat form --------------------------------------------

// Stage 1: [p1|p2|p3|p4|p5] = conv(x, wx) over R1; p_k (k < 5) rounded
// into slot k over R_k, p5 in float32 over the tile; then x1 in place.
__device__ __forceinline__ void v1_stage1(const Ctx& c, const Args& a) {
  constexpr int TILE = V1::TILE;
  constexpr int S = side(TILE, 1);
  constexpr int N = NF + 4 * G;
  auto ks = [](int) { return 4; };
  auto stage = [&](uint32_t a0, uint32_t b0, int pass, int s) {
    stage_x<S>(c, a, a0, pass, s);
    stage_b<N>(b0, a.img[0], s);
  };
  auto epi = [&](int pass, const float(&acc)[N / 2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = acc_pixel(pass, h);
      if (i >= S * S) continue;
      // columns [p1|p2|p3|p4|p5]: slot k (k < 5) or p5 from column 32 (k - 1)
#pragma unroll
      for (int k = 1; k <= 5; ++k) {
        const int o = k - 1;              // R_k's corner in R1
        const int sk = side(TILE, k);
        const int qy = i / S - o, qx = i % S - o;
        if (qy < 0 || qy >= sk || qx < 0 || qx >= sk) continue;
#pragma unroll
        for (int nb = 0; nb < (k < 5 ? G : NF) / 8; ++nb) {
          const int r = 4 * (4 * (k - 1) + nb) + 2 * h;
          const int ch = 8 * nb + acc_col();
          if (k < 5)
            sh<uint32_t>(c, c.vals + slot_off(TILE, k) + ((qy * sk + qx) * G + ch) * 2) =
                pack(acc[r], acc[r + 1]);
          else
            sh<float2>(c, c.vals + V1::P5 + ((qy * TILE + qx) * NF + ch) * 4) =
                make_float2(acc[r], acc[r + 1]);
        }
      }
    }
  };
  product<N, 9, SlabRing<N>>(c, S * S, ks, stage, AInRing(), NoBand(), epi);
  activate<TILE, 1>(c, a);
}

// Stage K (2..5): conv(g, wg_K) over R_K on all 128 lanes of the growth
// buffer, then x_K = lrelu((p_K + conv) + b_K) in place of p_K (K < 5,
// zero outside the image), or out = 0.2 ((p5 + conv) + b5) + x (K = 5).
template <int K>
__device__ __forceinline__ void v1_stage(const Ctx& c, const Args& a) {
  constexpr int TILE = V1::TILE;
  constexpr int S = side(TILE, K);
  constexpr int N = K < 5 ? G : NF;
  auto ks = [](int) { return 4; };
  auto stage = [&](uint32_t a0, uint32_t b0, int pass, int s) {
    // slab s: tap s / 2, lanes 64 (s % 2) .. + 63, i.e. chunks 0..3 of
    // x_{2h+1} and 4..7 of x_{2h+2} (h = s % 2); zero for x_K..x4, whose
    // weight rows are zero
    const int tap = s >> 1, h = s & 1;
    for (int e = threadIdx.x; e < PASS * 8; e += THREADS) {
      const int p = e >> 3, ch = e & 7;
      const int src = 2 * h + (ch >> 2) + 1;
      const int i = pass * PASS + p;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (src < K && i < S * S) {
        // pixel (qy, qx) of R_K sits at (qy + K - src, qx + K - src) in R_src
        const int ss = side(TILE, src), o = K - src - 1;
        const int qy = i / S + o + tap / 3, qx = i % S + o + tap % 3;
        v = sh<uint4>(c, c.vals + slot_off(TILE, src) +
                        ((qy * ss + qx) * G + 8 * (ch & 3)) * 2);
      }
      sh<uint4>(c, a_chunk(a0, p, ch)) = v;
    }
    stage_b<N>(b0, a.img[K - 1], s);
  };
  auto epi = [&](int pass, const float(&acc)[N / 2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = acc_pixel(pass, h);
      if (i >= S * S) continue;
      const int qy = i / S, qx = i % S;
      const int gy = c.oy0 - (5 - K) + qy, gx = c.ox0 - (5 - K) + qx;
      const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb) {
        const int r = 4 * nb + 2 * h;
        const int ch = 8 * nb + acc_col();
        if constexpr (K < 5) {
          const uint32_t at = c.vals + slot_off(TILE, K) + (i * G + ch) * 2;
          const float2 p = unpack(sh<uint32_t>(c, at));
          const float y0 = lrelu(__fadd_rn(__fadd_rn(p.x, acc[r]), __ldg(a.b14 + (K - 1) * G + ch)));
          const float y1 = lrelu(__fadd_rn(__fadd_rn(p.y, acc[r + 1]),
                                           __ldg(a.b14 + (K - 1) * G + ch + 1)));
          sh<uint32_t>(c, at) = inside ? pack(y0, y1) : 0u;
        } else {
          const float2 p5 = sh<float2>(c, c.vals + V1::P5 + (i * NF + ch) * 4);
          store_out(c, a, qy, qx, ch, __fadd_rn(p5.x, acc[r]),
                    __fadd_rn(p5.y, acc[r + 1]));
        }
      }
    }
  };
  product<N, 18, SlabRing<N>>(c, S * S, ks, stage, AInRing(), NoBand(), epi);
}

__global__ void __launch_bounds__(THREADS, 1) v1_tc_kernel(Args a) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const Ctx c = make_ctx<V1>(tc_smem);
  v1_stage1(c, a);
  v1_stage<2>(c, a);
  v1_stage<3>(c, a);
  v1_stage<4>(c, a);
  v1_stage<5>(c, a);
}

// --- launch and query --------------------------------------------------------

template <typename R>
int launch(void (*kernel)(Args), const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<R>;
  // set on every launch, so that it holds on whichever device is current
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(cdiv(a.W, C::TILE), cdiv(a.H, C::TILE), B);
  kernel<<<grid, THREADS, (size_t)C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename R>
long long field(void (*kernel)(Args), int what) {
  using C = Cfg<R>;
  switch (what) {
    case 0: return C::TILE;
    case 1: return PASS;
    case 2: return C::SMEM;
    case 3: return C::macs();
    case 4: {
      if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM) != cudaSuccess)
        return -1;
      int blocks = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                        (size_t)C::SMEM) != cudaSuccess)
        return -1;
      return blocks;
    }
  }
  return -1;
}

}  // namespace

// rung: 1 (v1), 2 (v2) or 3 (v3). x, out: (B, H, W, 64) bf16, contiguous, 16-byte
// aligned; img0..img4: the rung's five bf16 B images as
// ops/rdb_ladder.py::pack_tc_images packs them; b14: 128, b5: 64 float32.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int s2sr_rdb_ladder_tc_forward(int rung, const void* x, void* out,
                                          const void* img0, const void* img1,
                                          const void* img2, const void* img3,
                                          const void* img4, const void* b14,
                                          const void* b5, int B, int H, int W,
                                          void* stream) {
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  const void* imgs[5] = {img0, img1, img2, img3, img4};
  for (int j = 0; j < 5; ++j) a.img[j] = static_cast<const bf16*>(imgs[j]);
  a.b14 = static_cast<const float*>(b14);
  a.b5 = static_cast<const float*>(b5);
  a.H = H;
  a.W = W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rung == 1) return launch<V1>(v1_tc_kernel, a, B, st);
  if (rung == 2) return launch<V2>(v2_tc_kernel, a, B, st);
  if (rung == 3) return launch<V3>(v3_tc_kernel, a, B, st);
  return (int)cudaErrorInvalidValue;
}

// A tensor-core rung's tiling: what = 0 output tile side, 1 region pixels
// per pass, 2 dynamic shared-memory bytes per block, 3 multiply-adds
// executed per output tile (halo recompute, pass padding and v1's zero
// rows included), 4 blocks per SM; -1 for an unknown rung or field.
extern "C" long long s2sr_rdb_ladder_tc_query(int rung, int what) {
  if (rung == 1) return field<V1>(v1_tc_kernel, what);
  if (rung == 2) return field<V2>(v2_tc_kernel, what);
  if (rung == 3) return field<V3>(v3_tc_kernel, what);
  return -1;
}

// K8 and K9: the two products of the quantized projections, with the
// per-channel scale (and the bias) in the epilogue.
//
// K8 (srgpt_w8a8_gemm) replaces spatialrgpt_tpu/ops/layers.py::_w8a8_dot's
// product and epilogue (XLA in the reference, layers.py:30-41, then the
// bias of linear, layers.py:144-146):
//   acc = xq . q^T  (int8 x int8 -> int32, exact),
//   y = bf16( f32(acc) * (ascale[m] * scale[n]) (+ f32 bias[n]) ).
// K9 (srgpt_w8_gemm) replaces linear's int8 weight-only branch
// (layers.py:123-125): y = bf16( (x . q^T in f32) * scale[n] (+ f32 bias[n]) ),
// the weight converted to bf16 on the way (exact: |q| <= 127).
//
// Both operands are K-major: xq / x (M, K) row-major and q (N, K) row-major,
// the port's (out, in) weight; wgmma on 8-bit types takes only K-major
// operands, and TMA reads both as 2-D {K, rows} tensor maps, 128B-swizzled,
// zeros past every edge (ragged M, N and the K tail need no masked loads; a
// zero adds nothing to a sum).  The Hopper primitives (mbarrier, TMA, wgmma
// descriptors and fences, the tensor-map encoder) are attention_sm90.cuh's.
//
// Two forms, both a TMA ring filled by one producer thread and drained by
// two consumer warpgroups:
//
// * Decode form (every K9 call; K8 at M <= 128 rows, ops/int8_linear.py::
//   DECODE_MAX_M).  Bound: the weight's bytes (K9 at the decode's down
//   projection, 64 x 4096 x 14,336: 58.7 MB, 17.5 us at 3.35 TB/s; K8's
//   lm_head, 64 x 128,264 x 4096: 525 MB, 157 us).  A and B are swapped:
//   y^T (N x M) = q (N x K) . x^T, so a 64-channel slice of the weight is
//   wgmma's 64-row A and the M activation rows are its N, rounded up to 8,
//   16, 32 or 64 columns (legal s8 and bf16 widths): 8 rows cost 8 columns.
//   Rows past 64 take more 64-row tiles (grid z), each reading the weight
//   again; that is also K9's launch at M > 64, which the main path never
//   makes (there the contracting projections take W8A8 from 2048 rows on).
//   A CTA owns 128 channels (one warpgroup each 64) and one k range; both
//   warpgroups read the same x tile, x stays in L2.  K8: wgmma m64nWk32 s8 x
//   s8 -> s32, both operands from shared memory, one stage's products in
//   flight while the next is issued.  K9: each consumer converts its 64 x
//   128 int8 tile to bf16 A fragments in registers (two 4-byte shared loads
//   and a byte permute gather a thread's 4 bytes; x ^ 0x80 placed under the
//   exponent of 2^23 and 2^23 + 128 subtracted gives the exact f32, whose
//   high half is the bf16; no I2F) and runs wgmma m64nWk16 with A from
//   registers, converting k16 step kk + 1 while step kk's product runs.
//   Where the weight has few channel tiles (k/v: 8; down, q, o: 32), k is
//   split over a thread-block cluster of up to 8 CTAs, as far as all CTAs
//   still fit one wave of two per SM: every CTA leaves its 128 x W partial
//   in its shared memory and, after a cluster barrier, sums a share of the
//   rows over the cluster's ranks in rank order through distributed shared
//   memory (exact for K8's int32, the same order in every run for K9's
//   f32), then runs the epilogue: no global workspace, no counters, nothing
//   left behind between launches.  The ring holds ~110 KB (3-6 stages of
//   128 k), two CTAs an SM.
//
// * Large form (K8 at M > 128: the prefill's 20,480 rows and the tower's
//   93,312).  Bound: int8 operations (prefill gate 20,480 x 14,336 x 4096:
//   2.41 TOP, 1.22 ms at 1,979 TOP/s).  A persistent grid of one CTA per SM
//   walks 128 x 256 output tiles in a grouped raster order (8 row tiles per
//   group, so a group's weight columns stay in L2); a producer warp (its
//   warpgroup at setmaxnreg 40) streams 128 x 128 A and 256 x 128 B int8
//   tiles through a ring of 4 stages (48 KB each); two consumer warpgroups
//   (setmaxnreg 232) each run 4 wgmma m64n256k32 s8 per stage into 128 s32
//   accumulators a thread, one stage's products in flight while the next is
//   issued.  The ring runs on across tiles, so a tile's epilogue overlaps
//   the next tile's loads.  128 x 128 tiles at two CTAs an SM (a producer
//   warp, 96 registers a thread) took 2.218 ms at the prefill gate and
//   1.374 at SigLIP's fc1 against 1.988 and 1.203 for 128 x 256.
//
// Where the forms meet (H100, scripts/bench_qgemm.py): at 96 rows the
// decode form takes a decode step's K8 calls (32 x q, o, gate, up and the
// lm_head) in ~3.4 ms against the large form's ~3.7 (q / o 0.016 against
// 0.024 ms, gate even, the lm_head, read twice, 0.364 against 0.202), and
// likewise at 128 rows; hence DECODE_MAX_M = 128.
//
// K8's sums are exact in any order, so K8 equals its plain version bit for
// bit: the epilogue keeps the reference's order with explicit
// round-to-nearest operations (__int2float_rn, __fmul_rn(ascale, scale),
// __fmul_rn, __fadd_rn of the f32 bias: no contraction into an FMA), one
// cast.  K9's f32 sums run in the tensor core's order, then the splits' in
// rank order.  Both take an optional f32 (M, N) addend, added after the
// scale and before the bias: the LoRA side branch of linear, whose f32 sum
// the reference adds there (layers.py:132-146).  K % 16 == 0 (TMA's 16-byte row stride).  The tensor map of a
// weight is encoded once per (pointer, shape, box) and cached; x's is
// encoded per call.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "attention_sm90.cuh"

namespace cg = cooperative_groups;

namespace srgpt {
namespace qgemm {

using bf16 = __nv_bfloat16;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_barrier_sync;
using sm90::smem_u32;
using sm90::sw128_desc;
using sm90::wgmma_commit;
using sm90::wgmma_fence;

constexpr int BK = 128;         // int8 k per stage: one 128-byte swizzle atom
constexpr int ROW = 128;        // bytes of one row of an int8 stage tile (and of a bf16 atom)
constexpr int TILE_ROWS = 64;   // rows of one wgmma A tile: one warpgroup's
constexpr int BF16_ATOM = 64;   // bf16 k per 128-byte atom

// ---------------------------------------------------------------------------
// PTX wrappers beyond attention_sm90.cuh's
// ---------------------------------------------------------------------------

// one box of a 2-D tensor map {K, rows} into shared memory; completion is
// counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads of an accumulator across the wait
template <typename T, int N>
__device__ __forceinline__ void fence_acc(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<T, int>::value)
      asm volatile("" : "+r"(d[i])::"memory");
    else
      asm volatile("" : "+f"(d[i])::"memory");
  }
}

// D (64 x 8, s32, registers) (+)= A (64 x 32, int8, shared, K-major) * B (32 x 8, int8, shared, K-major)
__device__ __forceinline__ void wgmma_s8_n8(int (&d)[4], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 16, s32, registers) (+)= A (64 x 32, int8, shared, K-major) * B (32 x 16, int8, shared, K-major)
__device__ __forceinline__ void wgmma_s8_n16(int (&d)[8], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 32, s32, registers) (+)= A (64 x 32, int8, shared, K-major) * B (32 x 32, int8, shared, K-major)
__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, s32, registers) (+)= A (64 x 32, int8, shared, K-major) * B (32 x 64, int8, shared, K-major)
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 256, s32, registers) (+)= A (64 x 32, int8, shared, K-major) * B (32 x 256, int8, shared, K-major)
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 8, f32, registers) (+)= A (64 x 16, bf16 registers) * B (16 x 8, bf16, shared, K-major)
__device__ __forceinline__ void wgmma_bf16_n8_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 16, f32, registers) (+)= A (64 x 16, bf16 registers) * B (16 x 16, bf16, shared, K-major)
__device__ __forceinline__ void wgmma_bf16_n16_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 32, f32, registers) (+)= A (64 x 16, bf16 registers) * B (16 x 32, bf16, shared, K-major)
__device__ __forceinline__ void wgmma_bf16_n32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32, registers) (+)= A (64 x 16, bf16 registers) * B (16 x 64, bf16, shared, K-major)
__device__ __forceinline__ void wgmma_bf16_n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// the s8 product of one k32 step at width W (decode: the activation rows; large: the tile's columns)
template <int W>
__device__ __forceinline__ void mma_s8(int (&d)[W / 2], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (W == 8) wgmma_s8_n8(d, desc_a, desc_b, accumulate);
  else if constexpr (W == 16) wgmma_s8_n16(d, desc_a, desc_b, accumulate);
  else if constexpr (W == 32) wgmma_s8_n32(d, desc_a, desc_b, accumulate);
  else if constexpr (W == 64) wgmma_s8_n64(d, desc_a, desc_b, accumulate);
  else wgmma_s8_n256(d, desc_a, desc_b, accumulate);
}

// the bf16 product of one k16 step at width W, A from registers
template <int W>
__device__ __forceinline__ void mma_bf16_rs(float (&d)[W / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  if constexpr (W == 8) wgmma_bf16_n8_rs(d, a, desc_b, accumulate);
  else if constexpr (W == 16) wgmma_bf16_n16_rs(d, a, desc_b, accumulate);
  else if constexpr (W == 32) wgmma_bf16_n32_rs(d, a, desc_b, accumulate);
  else wgmma_bf16_n64_rs(d, a, desc_b, accumulate);
}

// four int8 (bytes 0-3 of w) -> two bf16x2 (bytes 0-1 in lo, 2-3 in hi),
// exact: a byte v ^ 0x80 is v + 128 (0..255); as the low mantissa bits of
// 2^23 it makes the f32 2^23 + 128 + v, and subtracting 2^23 + 128 leaves v,
// an integer of at most 8 significant bits, so the f32's high half is its bf16
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float MAGIC = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - MAGIC;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - MAGIC;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - MAGIC;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - MAGIC;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// the epilogue of one output: K8 f32(acc) * (ascale * scale), K9 acc *
// scale, then the f32 addend of the row (the LoRA branch's (x a) b * scale,
// layers.py:132-143; none where add_row is null), then the f32 bias, each
// rounded once (no contraction into an FMA)
template <bool A8, typename Acc>
__device__ __forceinline__ float epilogue(Acc v, float as, float sc, const float* __restrict__ add_row,
                                          const void* __restrict__ bias, int bias_kind, int n) {
  float y;
  if constexpr (A8)
    y = __fmul_rn(__int2float_rn(v), __fmul_rn(as, sc));
  else
    y = __fmul_rn(v, sc);
  if (add_row != nullptr) y = __fadd_rn(y, add_row[n]);
  if (bias_kind == 1)
    y = __fadd_rn(y, __bfloat162float(static_cast<const bf16*>(bias)[n]));
  else if (bias_kind == 2)
    y = __fadd_rn(y, static_cast<const float*>(bias)[n]);
  return y;
}

// ---------------------------------------------------------------------------
// decode form: y^T = q . x^T, W activation rows a tile
// ---------------------------------------------------------------------------

constexpr int DEC_CH = 2 * TILE_ROWS;    // weight channels per CTA: one consumer warpgroup each 64
constexpr int DEC_THREADS = 288;         // consumer warpgroups 0-1, then the producer warp
constexpr int DEC_CONSUMER_WARPS = 8;
constexpr int DEC_RING = 110 * 1024;     // the ring's budget: two CTAs an SM
constexpr int DEC_MAX_STAGES = 6;
constexpr int MAX_SPLITS = 8;            // the portable cluster size
constexpr int MIN_SPLIT_KT = 2;          // k tiles a split takes at least

template <bool A8, int W>
struct DecLayout {
  static constexpr int W_BYTES = DEC_CH * ROW;                // the int8 weight tile: 16 KB
  static constexpr int X_BYTES = W * ROW * (A8 ? 1 : 2);      // x's W rows: one atom (int8) or two (bf16)
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int STAGES = DEC_RING / STAGE < DEC_MAX_STAGES ? DEC_RING / STAGE : DEC_MAX_STAGES;
  static constexpr int LD = DEC_CH + 4;                       // 4-byte partials per row (+4: no bank conflicts)
  static constexpr int PART = W * LD * 4;                     // the CTA's partial, over the ring once it is drained
  static constexpr int BARS = STAGES * STAGE > PART ? STAGES * STAGE : PART;
  static constexpr int SMEM = BARS + 16 * STAGES + 1024;      // full and empty barriers, 1024 to align the base
};

// grid (splits, ceil(N / 128), ceil(M / W)), clusters of (splits, 1, 1):
// cluster rank r takes k tiles [r * kt_per_split, (r + 1) * kt_per_split)
template <bool A8, int W>
__global__ void __launch_bounds__(DEC_THREADS, 2)
decode_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
              const float* __restrict__ ascale, const float* __restrict__ scale, const void* __restrict__ bias,
              int bias_kind, const float* __restrict__ add, bf16* __restrict__ out, int M, int N, int KT,
              int kt_per_split) {
  using L = DecLayout<A8, W>;
  using Acc = typename std::conditional<A8, int, float>::type;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_full = base + L::BARS, bar_empty = bar_full + 8 * L::STAGES;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.y * DEC_CH, m0 = blockIdx.z * W;
  const int kt0 = rank * kt_per_split;
  const int nk = min(KT, kt0 + kt_per_split) - kt0;  // >= 1: the host makes no empty split
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, DEC_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Acc* part = reinterpret_cast<Acc*>(smem);  // [W][LD]: row m, channel c
  if (warp == DEC_CONSUMER_WARPS) {
    // ---------------- producer: one thread issues the TMA loads ----------------
    if (lane == 0) {
      for (int t = 0; t < nk; ++t) {
        const int st = t % L::STAGES;
        mbar_wait(bar_empty + 8 * st, ((t / L::STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(bar_full + 8 * st, L::STAGE);
        const uint32_t dst = base + st * L::STAGE;
        const int k = (kt0 + t) * BK;
        tma_load_2d(dst, &tm_w, bar_full + 8 * st, k, n0);
        tma_load_2d(dst + L::W_BYTES, &tm_x, bar_full + 8 * st, k, m0);
        if constexpr (!A8) tma_load_2d(dst + L::W_BYTES + W * ROW, &tm_x, bar_full + 8 * st, k + BF16_ATOM, m0);
      }
    }
    __syncwarp();
  } else {
    // ---------------- consumers: channels [64 wg, 64 wg + 64) of the CTA's ----------------
    const int wg = warp / 4, w4 = warp % 4, g = lane / 4, c = lane % 4;
    Acc acc[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0;
    for (int t = 0; t < nk; ++t) {
      const int st = t % L::STAGES;
      mbar_wait(bar_full + 8 * st, (t / L::STAGES) & 1);
      const uint32_t w_tile = base + st * L::STAGE + wg * TILE_ROWS * ROW;
      const uint32_t x_tile = base + st * L::STAGE + L::W_BYTES;
      if constexpr (A8) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          mma_s8<W>(acc, sw128_desc(w_tile + 32 * kk, 1, 64), sw128_desc(x_tile + 32 * kk, 1, 64), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: free its slot
        if (t > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * ((t - 1) % L::STAGES));
        }
      } else {
        // this thread's A fragments of the 8 k16 steps: rows g and g + 8 of
        // its warp's 16, bytes 2c, 2c + 1, 2c + 8, 2c + 9 of each 16-byte
        // chunk (chunk j of row r sits at chunk j ^ (r % 8), and r % 8 = g
        // for both rows); two 4-byte loads and one byte permute a row.  Step
        // kk + 1 is converted while step kk's product runs.
        const unsigned char* row0 = smem + st * L::STAGE + (wg * TILE_ROWS + 16 * w4 + g) * ROW;
        const unsigned char* row1 = row0 + 8 * ROW;
        const uint32_t sel = (c & 1) ? 0x7632 : 0x5410;
        const int off = 4 * (c >> 1);
        uint32_t a[BK / 16][4];
        auto convert = [&](int kk) {
          const int chunk = ((kk ^ g) & 7) * 16 + off;
          const uint32_t p0 = __byte_perm(*reinterpret_cast<const uint32_t*>(row0 + chunk),
                                          *reinterpret_cast<const uint32_t*>(row0 + chunk + 8), sel);
          const uint32_t p1 = __byte_perm(*reinterpret_cast<const uint32_t*>(row1 + chunk),
                                          *reinterpret_cast<const uint32_t*>(row1 + chunk + 8), sel);
          i8x4_to_bf16x4(p0, a[kk][0], a[kk][2]);
          i8x4_to_bf16x4(p1, a[kk][1], a[kk][3]);
        };
        convert(0);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wgmma_fence();
          mma_bf16_rs<W>(acc, a[kk], sw128_desc(x_tile + (kk / 4) * W * ROW + (kk % 4) * 32, 1, 64), 1);
          wgmma_commit();
          if (kk + 1 < BK / 16) convert(kk + 1);
        }
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      }
    }
    if constexpr (A8) {
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * ((nk - 1) % L::STAGES));
    }
    fence_acc(acc);
    // the ring is drained once every consumer is here: the partial goes over it
    named_barrier_sync(1, DEC_CONSUMER_WARPS * 32);
    const int ch = wg * TILE_ROWS + 16 * w4 + g;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[(8 * j + 2 * c + (e & 1)) * L::LD + ch + 8 * (e >> 1)] = acc[4 * j + e];
  }
  cluster.sync();  // every CTA's partial is in place

  // this rank's rows of the tile, 4 channels a thread: the splits' partials
  // summed in rank order, then the epilogue
  using V = typename std::conditional<A8, int4, float4>::type;
  const int rows = (W + splits - 1) / splits, r_begin = rank * rows, r_end = min(W, r_begin + rows);
  for (int i = threadIdx.x; i < (r_end - r_begin) * (DEC_CH / 4); i += DEC_THREADS) {
    const int r = r_begin + i / (DEC_CH / 4), cc = 4 * (i % (DEC_CH / 4));
    const int m = m0 + r;
    if (m >= M) continue;
    V s = *reinterpret_cast<const V*>(cluster.map_shared_rank(part, 0) + r * L::LD + cc);
    for (int q = 1; q < splits; ++q) {
      const V v = *reinterpret_cast<const V*>(cluster.map_shared_rank(part, q) + r * L::LD + cc);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float as = A8 ? ascale[m] : 1.0f;
    const Acc sv[4] = {s.x, s.y, s.z, s.w};
    bf16* orow = out + static_cast<long long>(m) * N;
    const float* arow = add == nullptr ? nullptr : add + static_cast<long long>(m) * N;
    const int n = n0 + cc;
    if ((N & 3) == 0 && n + 3 < N) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = epilogue<A8>(sv[e], as, scale[n + e], arow, bias, bias_kind, n + e);
      __nv_bfloat162 v2[2] = {__floats2bfloat162_rn(y[0], y[1]), __floats2bfloat162_rn(y[2], y[3])};
      *reinterpret_cast<uint2*>(orow + n) = *reinterpret_cast<const uint2*>(v2);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) orow[n + e] = __float2bfloat16_rn(epilogue<A8>(sv[e], as, scale[n + e], arow, bias, bias_kind, n + e));
    }
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// large form (K8, M > DECODE_MAX_M): persistent, 128 x 256 tiles
// ---------------------------------------------------------------------------

constexpr int LG_BM = 2 * TILE_ROWS;  // rows per tile: one consumer warpgroup each 64
constexpr int LG_BN = 256;            // columns per tile: m64n256k32
constexpr int LG_THREADS = 384;       // the producer warpgroup, then two consumer warpgroups
constexpr int LG_CONSUMER_WARPS = 8;
constexpr int LG_STAGES = 4;
constexpr int LG_A_BYTES = LG_BM * ROW;
constexpr int LG_STAGE = LG_A_BYTES + LG_BN * ROW;  // 48 KB
constexpr int LG_BARS = LG_STAGES * LG_STAGE;
constexpr int LG_SMEM = LG_BARS + 16 * LG_STAGES + 1024;
constexpr int GROUP_M = 8;            // row tiles per group of the raster order

// tile -> (row tile, column tile): groups of GROUP_M row tiles, each walked
// column tile by column tile, row tiles fastest
__device__ __forceinline__ void tile_coords(int tile, int tiles_m, int tiles_n, int& mb, int& nb) {
  const int group_size = GROUP_M * tiles_n, first_m = (tile / group_size) * GROUP_M;
  const int gm = min(tiles_m - first_m, GROUP_M), in_group = tile % group_size;
  mb = first_m + in_group % gm;
  nb = in_group / gm;
}

__global__ void __launch_bounds__(LG_THREADS, 1)
large_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
             const float* __restrict__ ascale, const float* __restrict__ scale, const void* __restrict__ bias,
             int bias_kind, const float* __restrict__ add, bf16* __restrict__ out, int M, int N, int KT, int tiles_m,
             int tiles_n) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_full = base + LG_BARS, bar_empty = bar_full + 8 * LG_STAGES;
  const int n_tiles = tiles_m * tiles_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < LG_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, LG_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: setmaxnreg gives its registers to the consumers ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int mb, nb;
        tile_coords(tile, tiles_m, tiles_n, mb, nb);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int st = it % LG_STAGES;
          mbar_wait(bar_empty + 8 * st, ((it / LG_STAGES) & 1) ^ 1);  // the first round passes at once
          mbar_expect_tx(bar_full + 8 * st, LG_STAGE);
          const uint32_t dst = base + st * LG_STAGE;
          tma_load_2d(dst, &tm_a, bar_full + 8 * st, kt * BK, mb * LG_BM);
          tma_load_2d(dst + LG_A_BYTES, &tm_b, bar_full + 8 * st, kt * BK, nb * LG_BN);
        }
      }
    }
  } else {
    // ---------------- consumers: rows [64 cw, 64 cw + 64) of each tile ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");  // 128 s32 accumulators a thread
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int mb, nb;
      tile_coords(tile, tiles_m, tiles_n, mb, nb);
      int acc[LG_BN / 2];
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int st = it % LG_STAGES;
        mbar_wait(bar_full + 8 * st, (it / LG_STAGES) & 1);
        const uint32_t a_tile = base + st * LG_STAGE + cw * TILE_ROWS * ROW;
        const uint32_t b_tile = base + st * LG_STAGE + LG_A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          mma_s8<LG_BN>(acc, sw128_desc(a_tile + 32 * kk, 1, 64), sw128_desc(b_tile + 32 * kk, 1, 64), kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: free its slot
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % LG_STAGES));
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % LG_STAGES));

      // epilogue: rows g and g + 8 of the warp's 16, columns 2c and 2c + 1
      // of each group of 8
      const int r0 = mb * LG_BM + cw * TILE_ROWS + 16 * warp + g;
      const bool pairs = (N & 1) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= M) continue;
        const float as = ascale[row];
        bf16* orow = out + static_cast<long long>(row) * N;
        const float* arow = add == nullptr ? nullptr : add + static_cast<long long>(row) * N;
#pragma unroll
        for (int j = 0; j < LG_BN / 8; ++j) {
          const int col = nb * LG_BN + 8 * j + 2 * c;
          if (col >= N) continue;
          const float y0 = epilogue<true>(acc[4 * j + 2 * h], as, scale[col], arow, bias, bias_kind, col);
          if (pairs) {
            const float y1 = epilogue<true>(acc[4 * j + 2 * h + 1], as, scale[col + 1], arow, bias, bias_kind, col + 1);
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(y0, y1);
          } else {
            orow[col] = __float2bfloat16_rn(y0);
            if (col + 1 < N)
              orow[col + 1] = __float2bfloat16_rn(
                  epilogue<true>(acc[4 * j + 2 * h + 1], as, scale[col + 1], arow, bias, bias_kind, col + 1));
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// a row-major (rows, K) int8 or bf16 matrix as a 2-D tensor map {K, rows}:
// boxes of one 128-byte atom x box_rows rows, 128B-swizzled, zeros past
// every edge
inline cudaError_t make_map_2d(CUtensorMap* map, const void* ptr, long long rows, long long K, int box_rows,
                               bool is_bf16) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int esize = is_bf16 ? 2 : 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(ROW / esize), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                  const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the weight's map, encoded once per (pointer, shape, box): the encoding is
// a function of these alone, so a hit is the map that encoding would give
constexpr size_t MAP_CACHE_MAX = 1 << 16;

inline cudaError_t weight_map(CUtensorMap* map, const void* q, long long N, long long K, int box_rows) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, long long, long long, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(q, N, K, box_rows);
  std::lock_guard<std::mutex> lock(mu);
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return cudaSuccess;
  }
  const cudaError_t err = make_map_2d(map, q, N, K, box_rows, false);
  if (err != cudaSuccess) return err;
  if (cache.size() >= MAP_CACHE_MAX) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = n > 0 ? n : 132;
  }
  return count[dev];
}

// k splits of a decode-form product of `tiles` CTA tiles over KT k tiles:
// doubled while all CTAs still fit one wave of two per SM (at K8's decode
// gate, 112 tiles, a partial second wave at 4 splits took 0.0324 ms, 2
// splits 0.0270 on an H100), each split keeping MIN_SPLIT_KT k tiles, at
// most MAX_SPLITS (16, a non-portable cluster, was slower at k / v); then
// trimmed so no split is empty
inline void decode_splits(int tiles, int KT, int& splits, int& per) {
  const int target = 2 * sm_count();
  int s = 1;
  while (s < MAX_SPLITS && static_cast<long long>(tiles) * 2 * s <= target && KT / (2 * s) >= MIN_SPLIT_KT) s *= 2;
  per = (KT + s - 1) / s;
  splits = (KT + per - 1) / per;
}

template <bool A8, int W>
cudaError_t launch_decode(const void* x, const void* q, const float* ascale, const float* scale, const void* bias,
                          int bias_kind, const float* add, bf16* out, int M, int N, int K, cudaStream_t stream) {
  using L = DecLayout<A8, W>;
  CUtensorMap tw, tx;
  cudaError_t err = weight_map(&tw, q, N, K, DEC_CH);
  if (err == cudaSuccess) err = make_map_2d(&tx, x, M, K, W, !A8);
  if (err != cudaSuccess) return err;
  auto kern = decode_kernel<A8, W>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int KT = (K + BK - 1) / BK, ch_tiles = (N + DEC_CH - 1) / DEC_CH, m_tiles = (M + W - 1) / W;
  int splits, per;
  decode_splits(ch_tiles * m_tiles, KT, splits, per);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, ch_tiles, m_tiles);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, tw, tx, ascale, scale, bias, bias_kind, add, out, M, N, KT, per);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool A8>
cudaError_t dispatch_decode(const void* x, const void* q, const float* ascale, const float* scale, const void* bias,
                            int bias_kind, const float* add, bf16* out, int M, int N, int K, cudaStream_t stream) {
  if (M <= 8) return launch_decode<A8, 8>(x, q, ascale, scale, bias, bias_kind, add, out, M, N, K, stream);
  if (M <= 16) return launch_decode<A8, 16>(x, q, ascale, scale, bias, bias_kind, add, out, M, N, K, stream);
  if (M <= 32) return launch_decode<A8, 32>(x, q, ascale, scale, bias, bias_kind, add, out, M, N, K, stream);
  return launch_decode<A8, 64>(x, q, ascale, scale, bias, bias_kind, add, out, M, N, K, stream);  // 64-row tiles
}

inline cudaError_t launch_large(const void* xq, const void* q, const float* ascale, const float* scale, const void* bias,
                         int bias_kind, const float* add, bf16* out, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t err = weight_map(&tb, q, N, K, LG_BN);
  if (err == cudaSuccess) err = make_map_2d(&ta, xq, M, K, LG_BM, false);
  if (err != cudaSuccess) return err;
  auto kern = large_kernel;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, LG_SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int tiles_m = (M + LG_BM - 1) / LG_BM, tiles_n = (N + LG_BN - 1) / LG_BN;
  const long long tiles = static_cast<long long>(tiles_m) * tiles_n;
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  kern<<<grid, LG_THREADS, LG_SMEM, stream>>>(ta, tb, ascale, scale, bias, bias_kind, add, out, M, N,
                                               (K + BK - 1) / BK, tiles_m, tiles_n);
  return cudaGetLastError();
}

// K8's forms (ops/int8_linear.py picks one)
enum Form : int { DECODE = 0, LARGE = 1 };

}  // namespace qgemm
}  // namespace srgpt

// bias_kind: 0 none, 1 bf16, 2 f32 (N,); add: null or f32 (M, N), added before the bias
extern "C" int srgpt_w8a8_gemm(const void* xq, const void* q, const void* ascale, const void* scale, const void* bias,
                               int bias_kind, const void* add, void* out, int M, int N, int K, int form, void* stream) {
  using namespace srgpt::qgemm;
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* as = static_cast<const float*>(ascale);
  const float* sc = static_cast<const float*>(scale);
  const float* ad = static_cast<const float*>(add);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t err;
  if (form == DECODE)
    err = dispatch_decode<true>(xq, q, as, sc, bias, bias_kind, ad, o, M, N, K, st);
  else if (form == LARGE)
    err = launch_large(xq, q, as, sc, bias, bias_kind, ad, o, M, N, K, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// the decode form at every M (M > 64: 64-row tiles)
extern "C" int srgpt_w8_gemm(const void* x, const void* q, const void* scale, const void* bias, int bias_kind,
                             const void* add, void* out, int M, int N, int K, void* stream) {
  using namespace srgpt::qgemm;
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_decode<false>(x, q, nullptr, static_cast<const float*>(scale), bias, bias_kind,
                                                 static_cast<const float*>(add), static_cast<bf16*>(out), M, N, K,
                                                 static_cast<cudaStream_t>(stream)));
}

// Hopper (sm_90a) main loop of the attention kernels: K1 (vit_attention.cu,
// SigLIP's D = 72, CLIP's 64) and K5 (grid_bias_attention.cu, SAM vit_h's D =
// 80 and vit_b's 64) at a head-dim width DMAX of 80, K1 also at DMAX = 128
// (InternViT-6B's D = 128), and K2 (prefill_attention.cu, llama's D = 128:
// causal x packed segment x window, GQA) and K4's forward
// (flash_attention_sm90.cu: K2's function plus the LSE) at DMAX = 128; then
// K4's dQ kernel (flash_dq_sm90_kernel), the same loop with one product
// more, and K4's dK/dV kernel (flash_dkv_sm90_kernel, end of the file), its
// key-stationary mirror.
//
// One CTA owns BM = 128 query rows and walks its key tiles of BN = 128:
//   - warpgroup 0 is the producer: one thread issues TMA loads of the Q
//     tile (once) and of each K/V tile into a ring of 2 stages, with a
//     full and an empty mbarrier per stage; setmaxnreg gives its registers
//     to the consumers.
//   - warpgroups 1 and 2 are consumers, 64 query rows each.  S = Q K^T is
//     DMAX / 16 wgmma m64n128k16 from shared memory (D zero-padded to DMAX
//     by TMA's out-of-bounds fill), f32 in registers.  The online softmax
//     runs in registers in the exp2 domain (the scale folded into
//     log2(e)); a row is spread over the 4 threads of a quad, so its max
//     and sum take two shuffles.  P is rounded to bf16 in registers (the
//     accumulator layout of S is the A-operand layout of the next product)
//     and O += P V is 8 wgmma m64n{DMAX}k16 with A from registers and V
//     read MN-major from shared memory, so V is never transposed.  O (64 x
//     DMAX f32) stays in registers; the epilogue divides by l and stores
//     bf16 through the caller's (B, S, H, D) strides.
//
// K1 and K5 (modes NO_BIAS, GRID, GRID64): a CTA is 128 positions of one
// (image, head) and walks every key tile; only the last one masks keys >=
// kv_len.  K2 (mode PREFILL) and K4's forward (mode FLASH_FWD): a CTA is the
// G = Hq / Hk query heads of one kv head x 128 / G positions (the Pallas
// kernel's fold_g): one 4-D TMA box {64, G, 128 / G, 1} puts position q0 +
// r / G, head hk * G + r % G in smem row r, and K and V are read once per kv
// head.  Key j is live for query i iff seg[j] == seg[i] != 0, j <= i and
// (no window or i - j < window).  Both sides walk the key tiles from the
// window's first to the causal last of the CTA's live queries (rows of
// segment 0 need none); FLASH_FWD walks only the tiles of that range that
// hold a key of the live queries' segment ids (list_live_tiles: in rows
// of 4 packed samples most causal tiles hold none).  The producer's warp
// copies each tile's segment ids into its stage beside the TMA loads.  A
// tile is masked per score only where a thread's rows meet the diagonal,
// the window edge or another segment; interior tiles are maskless.  Rows
// of segment 0 store zeros, rows >= S nothing; FLASH_FWD also stores each
// row's log-sum-exp, (m + log2 l) ln 2, and -1e30 for a row of segment 0.
//
// Shared-memory layout of a 128-row operand tile: two 64-column atoms of
// 128 rows x 128 bytes, each 1024-byte aligned and 128B-swizzled as TMA
// writes them (at DMAX = 80 columns 80-127 are TMA's zero fill past D, so
// one N = 80 product spans both atoms).  Q 32 KB + 2 stages x (K 32 KB + V
// 32 KB) = 160 KB; K5 adds its rel-pos bias rows, 64 KB, for 224 KB of the
// 227 KB a CTA may use; K2 adds 2 x 512 bytes of segment ids, FLASH_FWD
// those and 3 KB of tile list.  Ragged S, valid_len and D < DMAX need no
// masked loads: the tensor maps are 4-D {D, H, S, B} over the caller's
// strides and TMA fills zeros past each edge.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace srgpt {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;        // query rows per CTA (2 consumer warpgroups x 64)
constexpr int BN = 128;        // keys per tile
constexpr int ATOM = 64;       // bf16 columns of one 128-byte swizzle atom
constexpr int NARROW = 80;     // K1's and K5's DMAX (5 k-steps of 16; PV N = 80)
constexpr int WIDE = 128;      // K2's DMAX (8 k-steps; PV N = 128)
constexpr int NSTAGES = 2;     // K/V ring depth
constexpr int NTHREADS = 384;  // producer + 2 consumer warpgroups
constexpr int NCONSUMER = 256;
constexpr int ATOM_BYTES = 128 * ATOM * 2;     // 128 rows of one atom: 16 KB
constexpr int OPERAND_BYTES = 2 * ATOM_BYTES;  // a 128-row operand tile: 32 KB
constexpr int BIAS_LD = 64;                    // f32 per bias row (gh, gw <= 64)
constexpr int SEG_BYTES = BN * 4;              // K2: one key tile's int32 segment ids
constexpr float LOG2E = 1.4426950408889634f;

// what the kernel adds to or masks in the scaled scores
enum Mode : int {
  NO_BIAS = 0,  // K1: keys >= kv_len masked
  GRID = 1,     // K5, any grid width: each score looks its two terms up in shared memory
  GRID64 = 2,   // K5 at gw = 64 (SAM's grids): a 128-key tile is two whole grid rows, so a
                // thread's rel_w terms are the same in every tile (32 registers) and its
                // rel_h terms are 2 per row and tile
  PREFILL = 3,  // K2: causal x packed segment x window, G query heads per kv head
  FLASH_FWD = 4,  // K4's forward: PREFILL over the listed live tiles, plus the LSE
};

__host__ __device__ constexpr bool segmented(int mode) { return mode == PREFILL || mode == FLASH_FWD; }

// K4: a CTA lists at most MAX_TILES key tiles (S <= MAX_TILES x the tile
// width): a byte flag per tile, then the listed tiles' indices as int16
constexpr int MAX_TILES = 1024;
constexpr int TILE_LIST_BYTES = MAX_TILES + MAX_TILES * 2;
constexpr float NEG_INF = -1e30f;  // K4's LSE of a row with no live key
constexpr float LN2 = 0.6931471805599453f;

// byte offsets from the 1024-aligned base of dynamic shared memory
constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + OPERAND_BYTES;            // + stage * OPERAND_BYTES
constexpr int OFF_V = OFF_K + NSTAGES * OPERAND_BYTES;  // + stage * OPERAND_BYTES
constexpr int OFF_EXTRA = OFF_V + NSTAGES * OPERAND_BYTES;  // K5's bias rows or K2's / K4's segment ids
constexpr int BIAS_BYTES = 2 * BM * BIAS_LD * 4;        // rel_h rows, then rel_w rows
__host__ __device__ constexpr int extra_bytes(int mode) {
  return mode == GRID || mode == GRID64 ? BIAS_BYTES
         : mode == PREFILL              ? NSTAGES * SEG_BYTES
         : mode == FLASH_FWD            ? NSTAGES * SEG_BYTES + TILE_LIST_BYTES
                                        : 0;
}
__host__ __device__ constexpr int off_bars(int mode) { return OFF_EXTRA + extra_bytes(mode); }
// barriers (q_full, full[2], empty[2]), K2's live-query range (2 ints; K4's
// list_live_tiles: 5) and 1024 bytes to align the base
__host__ __device__ constexpr int smem_bytes(int mode) { return off_bars(mode) + 64 + 1024; }

struct Params {
  bf16* out;
  long long sob, sos, soh;  // element strides of the (B, S, H, D) output
  int S, H, D;
  int kv_len;               // K1: keys >= kv_len are masked (valid_len); K5: S
  float scale_log2;         // sm_scale * log2(e)
  const float* rel_h;       // K5: (B, H, S, gh) f32, contiguous
  const float* rel_w;       // K5: (B, H, S, gw) f32, contiguous
  int gh, gw;
  const int* seg;           // K2, K4: (B, S) int32 segment ids, contiguous; 0 = padding
  int G;                    // K2, K4: query heads per kv head (divides BM)
  int window;               // K2, K4: <= 0: none
  float* lse;               // K4: (B, Hq, S) f32, contiguous: the forward's output, dQ's input
  const float* delta;       // K4 dQ, dK/dV: (B, S, Hq) f32 rowsum(dO * O), contiguous
  float scale;              // K4 dQ, dK/dV: sm_scale
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the 4-D tensor map {D, H, S, B} into shared memory; completion
// is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout type 1 = SW128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving reads of an accumulator across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32, registers) (+)= A (64 x 16, shared, K-major) * B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32, registers) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 80, f32, registers) += A (64 x 16, bf16 registers) * B (16 x 80, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n80k16_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32, registers) += A (64 x 16, bf16 registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// bias rows in shared memory: row r's entry c sits at r * 64 + (c ^ swz),
// so the 8 rows a warp reads at once fall in different banks
__device__ __forceinline__ int rel_h_at(int r, int kh) { return r * BIAS_LD + (kh ^ (r & 7)); }
__device__ __forceinline__ int rel_w_at(int r, int kw) { return r * BIAS_LD + (kw ^ ((r & 7) << 3)); }

// K4: lists at `list`, in ascending order, the tiles of T positions that
// the CTA's live rows (positions q0 .. q0 + BQ - 1 before S in a nonzero
// segment of the row's ids `seg`) meet, and returns how many (the same in
// every thread; called by all of them).  Forward and dQ (KEYS false): the
// rows are queries and a key tile is listed if it lies between the
// window's first and the causal last of the live queries.  dK/dV (KEYS
// true): the rows are keys and a query tile is listed if it lies between
// the first live key and the last query within the window of the last live
// key (the row's end without a window).  Either way the tile must hold a
// position whose segment id lies in the live rows' id range.  That is exact
// for any id layout, since a live pair has equal ids: the reference's
// cross-segment tile skip (flash_attention.py:133-145), judged on the ids
// themselves.  `scratch`: 5 ints of shared memory that thread 0 set to
// INT_MAX, -1, INT_MAX, INT_MIN before the last __syncthreads.
template <int T, bool KEYS = false>
__device__ __forceinline__ int list_live_tiles(const int* seg, int S, int window, int q0, int BQ, int* scratch,
                                               unsigned char* flags, short* list) {
  for (int w = threadIdx.x; w < MAX_TILES / 4; w += NTHREADS) reinterpret_cast<int*>(flags)[w] = 0;
  if (threadIdx.x < BQ) {
    const int i = q0 + threadIdx.x;
    const int id = i < S ? seg[i] : 0;
    if (id != 0) {
      atomicMin(&scratch[0], i);
      atomicMax(&scratch[1], i);
      atomicMin(&scratch[2], id);
      atomicMax(&scratch[3], id);
    }
  }
  __syncthreads();
  const int first = scratch[0], last = scratch[1], id_lo = scratch[2], id_hi = scratch[3];
  if (last < 0) return 0;  // no live row: uniform over the CTA
  int lo, hi;
  if constexpr (KEYS) {
    lo = first;
    hi = window > 0 && window < S - last ? last + window - 1 : S - 1;
  } else {
    lo = window > 0 ? max(first - window + 1, 0) : 0;
    hi = last;
  }
  const int t_begin = lo / T;
  // 8 loads in flight per thread: one pass over a 4096-position row
  constexpr int U = 8;
  for (int j0 = lo + threadIdx.x; j0 <= hi; j0 += U * NTHREADS) {
    int ids[U];
#pragma unroll
    for (int u = 0; u < U; ++u) ids[u] = j0 + u * NTHREADS <= hi ? seg[j0 + u * NTHREADS] : 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (ids[u] != 0 && id_lo <= ids[u] && ids[u] <= id_hi) flags[(j0 + u * NTHREADS) / T - t_begin] = 1;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, n = hi / T + 1 - t_begin;
    int count = 0;
    for (int c = 0; c < n; c += 32) {
      const bool f = c + lane < n && flags[c + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[count + __popc(m & ((1u << lane) - 1))] = static_cast<short>(t_begin + c + lane);
      count += __popc(m);
    }
    if (lane == 0) scratch[4] = count;
  }
  __syncthreads();
  return scratch[4];
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int DMAX, int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const Params p) {
  static_assert(DMAX == NARROW || DMAX == WIDE, "DMAX is 80 or 128");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  constexpr bool HAS_BIAS = MODE == GRID || MODE == GRID64;
  constexpr bool SEGMENTS = segmented(MODE);
  constexpr bool LISTED = MODE == FLASH_FWD;  // walks list_live_tiles' tiles and stores the LSE
  const uint32_t bar_q = base + off_bars(MODE);
  const uint32_t bar_full = bar_q + 8;    // + 8 * stage
  const uint32_t bar_empty = bar_q + 24;  // + 8 * stage
  // K2: first, last live query; K4: list_live_tiles' scratch
  int* live_range = reinterpret_cast<int*>(smem + off_bars(MODE) + 40);
  unsigned char* tile_flags = smem + OFF_EXTRA + NSTAGES * SEG_BYTES;  // K4
  const short* tile_list = reinterpret_cast<const short*>(tile_flags + MAX_TILES);

  // h: the head (K1, K5) or the kv head (K2); q0: the CTA's first position
  const int b = blockIdx.z, h = blockIdx.y;
  const int BQ = SEGMENTS ? BM / p.G : BM;
  const int q0 = blockIdx.x * BQ;
  int t_begin = 0, n_tiles = (p.kv_len + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(bar_full + 8 * s, SEGMENTS ? 2 : 1);  // K2: the TMA bytes and the segment ids
      mbar_init(bar_empty + 8 * s, NCONSUMER);
    }
    if constexpr (SEGMENTS) {
      live_range[0] = INT_MAX;
      live_range[1] = -1;
    }
    if constexpr (LISTED) {
      live_range[2] = INT_MAX;
      live_range[3] = INT_MIN;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (LISTED) {
    // the Q tile loads while the CTA lists its key tiles
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, OPERAND_BYTES);
      for (int a = 0; a < 2; ++a) tma_load_4d(base + OFF_Q + a * ATOM_BYTES, &tm_q, bar_q, a * ATOM, h * p.G, q0, b);
    }
    n_tiles = list_live_tiles<BN>(p.seg + static_cast<long long>(b) * p.S, p.S, p.window, q0, BQ, live_range,
                                  tile_flags, const_cast<short*>(tile_list));
  } else if constexpr (SEGMENTS) {
    // the key tiles the CTA's live queries need: [first - window + 1, last]
    if (threadIdx.x < BQ) {
      const int i = q0 + threadIdx.x;
      if (i < p.S && p.seg[static_cast<long long>(b) * p.S + i] != 0) {
        atomicMin(&live_range[0], i);
        atomicMax(&live_range[1], i);
      }
    }
    __syncthreads();
    const int first = live_range[0], last = live_range[1];
    t_begin = p.window > 0 && last >= 0 ? max(first - p.window + 1, 0) / BN : 0;
    n_tiles = last < 0 ? 0 : last / BN + 1 - t_begin;
  }

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if constexpr (SEGMENTS) {
      // K2: lane 0 issues the TMA loads; the whole warp copies each key
      // tile's segment ids into its stage (4 a lane), and lane 0 arrives
      // on the stage's full barrier once more for them
      const int lane = threadIdx.x;
      if (lane < 32) {
        if (!LISTED && lane == 0) {
          mbar_expect_tx(bar_q, OPERAND_BYTES);
          for (int a = 0; a < 2; ++a)
            tma_load_4d(base + OFF_Q + a * ATOM_BYTES, &tm_q, bar_q, a * ATOM, h * p.G, q0, b);
        }
        for (int n = 0; n < n_tiles; ++n) {
          const int st = n % NSTAGES;
          const int j0 = (LISTED ? tile_list[n] : t_begin + n) * BN;
          mbar_wait(bar_empty + 8 * st, ((n / NSTAGES) & 1) ^ 1);  // the first round passes at once
          if (lane == 0) {
            mbar_expect_tx(bar_full + 8 * st, 2 * OPERAND_BYTES);
            for (int a = 0; a < 2; ++a) {
              tma_load_4d(base + OFF_K + st * OPERAND_BYTES + a * ATOM_BYTES, &tm_k, bar_full + 8 * st, a * ATOM,
                          h, j0, b);
              tma_load_4d(base + OFF_V + st * OPERAND_BYTES + a * ATOM_BYTES, &tm_v, bar_full + 8 * st, a * ATOM,
                          h, j0, b);
            }
          }
          int ids[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + 4 * lane + u;
            ids[u] = j < p.S ? p.seg[static_cast<long long>(b) * p.S + j] : 0;
          }
          *reinterpret_cast<int4*>(smem + OFF_EXTRA + st * SEG_BYTES + 16 * lane) =
              make_int4(ids[0], ids[1], ids[2], ids[3]);
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_full + 8 * st);
        }
      }
    } else if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, OPERAND_BYTES);
      for (int a = 0; a < 2; ++a) tma_load_4d(base + OFF_Q + a * ATOM_BYTES, &tm_q, bar_q, a * ATOM, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % NSTAGES;
        const uint32_t ph = (t / NSTAGES) & 1;
        mbar_wait(bar_empty + 8 * st, ph ^ 1);  // the first round passes at once
        mbar_expect_tx(bar_full + 8 * st, 2 * OPERAND_BYTES);
        for (int a = 0; a < 2; ++a) {
          tma_load_4d(base + OFF_K + st * OPERAND_BYTES + a * ATOM_BYTES, &tm_k, bar_full + 8 * st, a * ATOM, h,
                      t * BN, b);
          tma_load_4d(base + OFF_V + st * OPERAND_BYTES + a * ATOM_BYTES, &tm_v, bar_full + 8 * st, a * ATOM, h,
                      t * BN, b);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;  // query rows [64 cw, 64 cw + 64) of the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r_lo = 64 * cw + 16 * warp + lane / 4;  // this thread's rows: r_lo and r_lo + 8
    const int cq = 2 * (lane % 4);                    // its first column in each group of 8

    float* s_rel_h = reinterpret_cast<float*>(smem + OFF_EXTRA);
    float* s_rel_w = s_rel_h + BM * BIAS_LD;
    if constexpr (HAS_BIAS) {
      // this warpgroup's 64 bias rows are contiguous in device memory
      const long long row0 = (static_cast<long long>(b) * p.H + h) * p.S + q0 + 64 * cw;
      const int rows = min(64, p.S - q0 - 64 * cw);
      // two rows per pass, one column per thread (gh, gw <= 64)
      const int c = tid % 64;
#pragma unroll 4
      for (int r = tid / 64; r < 64; r += 2) {
        if (c < p.gh) s_rel_h[rel_h_at(64 * cw + r, c)] = r < rows ? p.rel_h[(row0 + r) * p.gh + c] * LOG2E : 0.f;
        if (c < p.gw) s_rel_w[rel_w_at(64 * cw + r, c)] = r < rows ? p.rel_w[(row0 + r) * p.gw + c] * LOG2E : 0.f;
      }
      named_barrier_sync(1 + cw, 128);
    }
    const float inv_gw = MODE == GRID ? 1.f / static_cast<float>(p.gw) : 0.f;
    // GRID64: rel_w of this thread's two rows at its 16 columns mod 64
    float rw[2][8][2];
    if constexpr (MODE == GRID64) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) rw[hr][jj][e] = s_rel_w[rel_w_at(r_lo + 8 * hr, 8 * jj + cq + e)];
    }
    // PREFILL, FLASH_FWD: position and segment of this thread's two rows; -1 for a
    // row of segment 0 or past S (it needs no key and stores zeros)
    int pos[2] = {-1, -1}, sid[2] = {0, 0};
    if constexpr (SEGMENTS) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = q0 + (r_lo + 8 * hr) / p.G;
        sid[hr] = i < p.S ? p.seg[static_cast<long long>(b) * p.S + i] : 0;
        pos[hr] = sid[hr] != 0 ? i : -1;
      }
    }

    float o[DMAX / 2];
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

    mbar_wait(bar_q, 0);
    const uint32_t q_tile = base + OFF_Q + cw * 64 * 128;  // 64 rows x 128 bytes into each atom

    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % NSTAGES;
      const int t = LISTED ? tile_list[n] : t_begin + n;
      mbar_wait(bar_full + 8 * st, (n / NSTAGES) & 1);
      const uint32_t k_tile = base + OFF_K + st * OPERAND_BYTES;
      const uint32_t v_tile = base + OFF_V + st * OPERAND_BYTES;

      // ---- S = Q K^T: DMAX / 16 k-steps of 16 columns (4 per atom) ----
      float s[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        const uint32_t off = (kk / 4) * ATOM_BYTES + (kk % 4) * 32;
        wgmma_m64n128k16_ss(s, sw128_desc(q_tile + off, 1, 64), sw128_desc(k_tile + off, 1, 64), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // ---- scores in the exp2 domain, bias, masks ----
      const int j0 = t * BN;
      float rh[2][2];  // GRID64: rel_h of this thread's rows at the tile's two grid rows
      if constexpr (MODE == GRID64) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int g = 0; g < 2; ++g) rh[hr][g] = s_rel_h[rel_h_at(r_lo + 8 * hr, min(2 * t + g, BIAS_LD - 1))];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int jj = i / 4, hr = (i >> 1) & 1, e = i & 1;
        float x = s[i] * p.scale_log2;
        if constexpr (MODE == GRID64) {
          x += rh[hr][jj / 8] + rw[hr][jj % 8][e];
        } else if constexpr (MODE == GRID) {
          const int key = j0 + 8 * jj + cq + e;
          if (key < p.kv_len) {  // past S, the grid row would fall outside the bias rows
            const int r = r_lo + 8 * hr;
            const int kh = __float2int_rz((static_cast<float>(key) + 0.5f) * inv_gw);
            x += s_rel_h[rel_h_at(r, kh)] + s_rel_w[rel_w_at(r, key - kh * p.gw)];
          }
        }
        s[i] = x;
      }
      if constexpr (SEGMENTS) {
        // the tile's segment range (per warp), then per thread: does any
        // live row of this thread meet the diagonal, the window edge or
        // another segment in this tile?
        const int* kseg = reinterpret_cast<const int*>(smem + OFF_EXTRA + st * SEG_BYTES);
        const int4 ids = *reinterpret_cast<const int4*>(kseg + 4 * lane);
        const int kmin = __reduce_min_sync(0xffffffffu, min(min(ids.x, ids.y), min(ids.z, ids.w)));
        const int kmax = __reduce_max_sync(0xffffffffu, max(max(ids.x, ids.y), max(ids.z, ids.w)));
        bool interior = true;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          if (pos[hr] >= 0)
            interior = interior && kmin == sid[hr] && kmax == sid[hr] && j0 + BN - 1 <= pos[hr] &&
                       (p.window <= 0 || pos[hr] - j0 < p.window);
        if (!interior) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int hr = (i >> 1) & 1, c = 8 * (i / 4) + cq + (i & 1), j = j0 + c;
            const bool live =
                kseg[c] == sid[hr] && j <= pos[hr] && (p.window <= 0 || pos[hr] - j < p.window);
            if (!live) s[i] = -INFINITY;
          }
        }
      } else if (j0 + BN > p.kv_len) {  // only the last tile masks; the interior tiles are maskless
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          if (j0 + 8 * (i / 4) + cq + (i & 1) >= p.kv_len) s[i] = -INFINITY;
      }

      // ---- online softmax: rows r_lo (hr = 0) and r_lo + 8 (hr = 1) ----
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          if (((i >> 1) & 1) == hr) mx = fmaxf(mx, s[i]);
        const float m_new = fmaxf(m_run[hr], quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no live key yet
        alpha[hr] = exp2f(m_run[hr] - m_use);
        m_run[hr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          if (((i >> 1) & 1) == hr) {
            s[i] = exp2f(s[i] - m_use);
            sum += s[i];
          }
        l_run[hr] = l_run[hr] * alpha[hr] + sum;
      }
#pragma unroll
      for (int i = 0; i < DMAX / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // ---- O += P V: 8 k-steps of 16 keys, P from registers ----
      uint32_t pa[BN / 16][4];  // all of P in bf16 before the fence, so no wgmma waits on a conversion
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) pa[kk][c] = pack_bf16(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        // V MN-major: 8-key groups 1024 bytes apart (SBO), the two 64-column
        // atoms ATOM_BYTES apart (LBO)
        const uint64_t desc = sw128_desc(v_tile + kk * 16 * 128, ATOM_BYTES / 16, 64);
        if constexpr (DMAX == WIDE)
          wgmma_m64n128k16_rs(o, pa[kk], desc);
        else
          wgmma_m64n80k16_rs(o, pa[kk], desc);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(bar_empty + 8 * st);
    }

    // ---- epilogue: O / l through the caller's strides ----
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float l = quad_sum(l_run[hr]);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      int row = q0 + r_lo + 8 * hr, head = h;
      if constexpr (SEGMENTS) {
        const int r = r_lo + 8 * hr;
        row = q0 + r / p.G;
        head = h * p.G + r % p.G;
      }
      const bool dead = SEGMENTS && pos[hr] < 0;  // a row of segment 0 stores zeros
      if constexpr (LISTED) {
        // the quad's rows share m and l: its first thread stores the LSE
        if (row < p.S && cq == 0)
          p.lse[(static_cast<long long>(b) * p.H + head) * p.S + row] =
              dead || l <= 0.f ? NEG_INF : (m_run[hr] + log2f(l)) * LN2;
      }
      if (row < p.S) {
        bf16* dst = p.out + b * p.sob + row * p.sos + head * p.soh;
#pragma unroll
        for (int j = 0; j < DMAX / 8; ++j) {
          const int col = 8 * j + cq;
          if (col < p.D)
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                dead ? __floats2bfloat162_rn(0.f, 0.f)
                     : __floats2bfloat162_rn(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4's dQ kernel: the same query-stationary loop with one product more
// ---------------------------------------------------------------------------
//
// A CTA is FLASH_FWD's fold (G heads x 128 / G positions of one kv head); it
// loads its Q and dO tiles once by the same 4-D box (dO has q's layout) and
// walks list_live_tiles' key tiles of DQ_BN = 64 keys.  Per tile, each
// consumer warpgroup (64 rows):
//   S = Q K^T and dP = dO V^T: 2 x 8 wgmma m64n64k16 from shared memory (K
//   and V K-major), one commit;
//   P = exp2(S scale log2(e) - lse log2(e)) on the live pairs, 0 elsewhere
//   (not rounded, as _bwd_dq_kernel); dS = P (dP - delta) scale, rounded to
//   bf16 in registers (S's accumulator layout is the A-operand layout);
//   dQ += dS K: 4 wgmma m64n128k16, A from registers, K read MN-major as V
//   is in P V.
// dQ (64 f32), S and dP (32 each) and packed dS (16) fit the consumers' 232
// registers at 64-key tiles; at 128 S and dP alone would take 128.  Shared
// memory: Q 32 KB + dO 32 KB + 4 stages x (K 16 KB + V 16 KB) + ids and the
// tile list, 197 KB.  Rows of segment 0 store zeros (their lse reads as
// +inf in log2 units, so P is 0), rows >= S nothing.  No atomics: dQ is
// apart from dK/dV, so the result is deterministic.

constexpr int DQ_BN = 64;                                  // keys per dQ tile
constexpr int DQ_STAGES = 4;                               // K/V ring depth
constexpr int ATOM64_BYTES = DQ_BN * 128;                  // 64 rows of one atom: 8 KB
constexpr int KV64_BYTES = 2 * ATOM64_BYTES;               // a 64-row operand tile: 16 KB
constexpr int DQ_OFF_Q = 0;
constexpr int DQ_OFF_DO = OPERAND_BYTES;
constexpr int DQ_OFF_K = 2 * OPERAND_BYTES;                // + stage * KV64_BYTES
constexpr int DQ_OFF_V = DQ_OFF_K + DQ_STAGES * KV64_BYTES;  // + stage * KV64_BYTES
constexpr int DQ_OFF_SEG = DQ_OFF_V + DQ_STAGES * KV64_BYTES;  // + stage * DQ_BN * 4
constexpr int DQ_OFF_LIST = DQ_OFF_SEG + DQ_STAGES * DQ_BN * 4;
constexpr int DQ_OFF_BARS = DQ_OFF_LIST + TILE_LIST_BYTES;
// barriers (q_full, full[4], empty[4]), list_live_tiles' 5 ints, alignment
constexpr int DQ_SMEM_BYTES = DQ_OFF_BARS + 128 + 1024;

template <int DMAX>  // 128: instantiated only where it is launched (flash_attention_sm90.cu)
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  static_assert(DMAX == WIDE, "dQ runs at the head-dim width 128");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + DQ_OFF_BARS;
  const uint32_t bar_full = bar_q + 8;                   // + 8 * stage
  const uint32_t bar_empty = bar_q + 8 + 8 * DQ_STAGES;  // + 8 * stage
  int* scratch = reinterpret_cast<int*>(smem + DQ_OFF_BARS + 8 + 16 * DQ_STAGES);
  unsigned char* tile_flags = smem + DQ_OFF_LIST;
  short* tile_list = reinterpret_cast<short*>(tile_flags + MAX_TILES);

  const int b = blockIdx.z, h = blockIdx.y;  // h: the kv head
  const int BQ = BM / p.G;
  const int q0 = blockIdx.x * BQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 2);  // the TMA bytes and the segment ids
      mbar_init(bar_empty + 8 * s, NCONSUMER);
    }
    scratch[0] = INT_MAX;
    scratch[1] = -1;
    scratch[2] = INT_MAX;
    scratch[3] = INT_MIN;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q and dO load while the CTA lists its key tiles
    mbar_expect_tx(bar_q, 2 * OPERAND_BYTES);
    for (int a = 0; a < 2; ++a) {
      tma_load_4d(base + DQ_OFF_Q + a * ATOM_BYTES, &tm_q, bar_q, a * ATOM, h * p.G, q0, b);
      tma_load_4d(base + DQ_OFF_DO + a * ATOM_BYTES, &tm_do, bar_q, a * ATOM, h * p.G, q0, b);
    }
  }
  const int n_tiles = list_live_tiles<DQ_BN>(p.seg + static_cast<long long>(b) * p.S, p.S, p.window, q0, BQ,
                                             scratch, tile_flags, tile_list);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    // lane 0 issues the TMA loads, the warp copies each tile's ids (2 a lane)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lane = threadIdx.x;
    if (lane < 32) {
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % DQ_STAGES;
        const int j0 = tile_list[n] * DQ_BN;
        mbar_wait(bar_empty + 8 * st, ((n / DQ_STAGES) & 1) ^ 1);  // the first round passes at once
        if (lane == 0) {
          mbar_expect_tx(bar_full + 8 * st, 2 * KV64_BYTES);
          for (int a = 0; a < 2; ++a) {
            tma_load_4d(base + DQ_OFF_K + st * KV64_BYTES + a * ATOM64_BYTES, &tm_k, bar_full + 8 * st, a * ATOM,
                        h, j0, b);
            tma_load_4d(base + DQ_OFF_V + st * KV64_BYTES + a * ATOM64_BYTES, &tm_v, bar_full + 8 * st, a * ATOM,
                        h, j0, b);
          }
        }
        int ids[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + 2 * lane + u;
          ids[u] = j < p.S ? p.seg[static_cast<long long>(b) * p.S + j] : 0;
        }
        *reinterpret_cast<int2*>(smem + DQ_OFF_SEG + st * DQ_BN * 4 + 8 * lane) = make_int2(ids[0], ids[1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_full + 8 * st);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;  // query rows [64 cw, 64 cw + 64) of the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r_lo = 64 * cw + 16 * warp + lane / 4;  // this thread's rows: r_lo and r_lo + 8
    const int cq = 2 * (lane % 4);                    // its first column in each group of 8

    // position, segment, lse (log2 units) and delta of this thread's two
    // rows; a row of segment 0 or past S has position -1 and lse +inf
    int pos[2], sid[2];
    float lse2[2], dlt[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r_lo + 8 * hr;
      const int i = q0 + r / p.G, head = h * p.G + r % p.G;
      sid[hr] = i < p.S ? p.seg[static_cast<long long>(b) * p.S + i] : 0;
      pos[hr] = sid[hr] != 0 ? i : -1;
      lse2[hr] = pos[hr] >= 0 ? p.lse[(static_cast<long long>(b) * p.H + head) * p.S + i] * LOG2E : INFINITY;
      dlt[hr] = pos[hr] >= 0 ? p.delta[(static_cast<long long>(b) * p.S + i) * p.H + head] : 0.f;
    }

    float dq[WIDE / 2];
#pragma unroll
    for (int i = 0; i < WIDE / 2; ++i) dq[i] = 0.f;

    mbar_wait(bar_q, 0);
    const uint32_t q_tile = base + DQ_OFF_Q + cw * 64 * 128;  // 64 rows x 128 bytes into each atom
    const uint32_t do_tile = base + DQ_OFF_DO + cw * 64 * 128;

    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % DQ_STAGES;
      const int j0 = tile_list[n] * DQ_BN;
      mbar_wait(bar_full + 8 * st, (n / DQ_STAGES) & 1);
      const uint32_t k_tile = base + DQ_OFF_K + st * KV64_BYTES;
      const uint32_t v_tile = base + DQ_OFF_V + st * KV64_BYTES;

      // ---- S = Q K^T and dP = dO V^T: 8 k-steps of 16 columns each ----
      float s[DQ_BN / 2], dp[DQ_BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WIDE / 16; ++kk) {
        const uint32_t oq = (kk / 4) * ATOM_BYTES + (kk % 4) * 32, okv = (kk / 4) * ATOM64_BYTES + (kk % 4) * 32;
        wgmma_m64n64k16_ss(s, sw128_desc(q_tile + oq, 1, 64), sw128_desc(k_tile + okv, 1, 64), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < WIDE / 16; ++kk) {
        const uint32_t oq = (kk / 4) * ATOM_BYTES + (kk % 4) * 32, okv = (kk / 4) * ATOM64_BYTES + (kk % 4) * 32;
        wgmma_m64n64k16_ss(dp, sw128_desc(do_tile + oq, 1, 64), sw128_desc(v_tile + okv, 1, 64), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // ---- is the tile interior for this thread's live rows? (FLASH_FWD's test at 64 keys) ----
      const int* kseg = reinterpret_cast<const int*>(smem + DQ_OFF_SEG + st * DQ_BN * 4);
      const int2 ids = *reinterpret_cast<const int2*>(kseg + 2 * lane);
      const int kmin = __reduce_min_sync(0xffffffffu, min(ids.x, ids.y));
      const int kmax = __reduce_max_sync(0xffffffffu, max(ids.x, ids.y));
      bool interior = true;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (pos[hr] >= 0)
          interior = interior && kmin == sid[hr] && kmax == sid[hr] && j0 + DQ_BN - 1 <= pos[hr] &&
                     (p.window <= 0 || pos[hr] - j0 < p.window);

      // ---- dS = P (dP - delta) scale, P = 0 off the live pairs ----
#pragma unroll
      for (int i = 0; i < DQ_BN / 2; ++i) {
        const int hr = (i >> 1) & 1;
        float pr = exp2f(s[i] * p.scale_log2 - lse2[hr]);
        if (!interior) {
          const int c = 8 * (i / 4) + cq + (i & 1), j = j0 + c;
          const bool live = kseg[c] == sid[hr] && j <= pos[hr] && (p.window <= 0 || pos[hr] - j < p.window);
          if (!live) pr = 0.f;
        }
        s[i] = pr * (dp[i] - dlt[hr]) * p.scale;
      }

      // ---- dQ += dS K: 4 k-steps of 16 keys, dS from registers ----
      uint32_t da[DQ_BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) da[kk][c] = pack_bf16(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk)
        // K MN-major: 8-key groups 1024 bytes apart (SBO), its two 64-column
        // atoms ATOM64_BYTES apart (LBO)
        wgmma_m64n128k16_rs(dq, da[kk], sw128_desc(k_tile + kk * 16 * 128, ATOM64_BYTES / 16, 64));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      mbar_arrive(bar_empty + 8 * st);
    }

    // ---- epilogue: dQ through the caller's strides ----
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r_lo + 8 * hr;
      const int row = q0 + r / p.G, head = h * p.G + r % p.G;
      if (row < p.S) {
        bf16* dst = p.out + b * p.sob + row * p.sos + head * p.soh;
#pragma unroll
        for (int j = 0; j < WIDE / 8; ++j) {
          const int col = 8 * j + cq;
          if (col < p.D)
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                pos[hr] < 0 ? __floats2bfloat162_rn(0.f, 0.f)
                            : __floats2bfloat162_rn(dq[4 * j + 2 * hr], dq[4 * j + 2 * hr + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4's dK/dV kernel: the key-stationary mirror of dQ
// ---------------------------------------------------------------------------
//
// A CTA owns BM = 128 keys of one kv head of one row; each consumer
// warpgroup owns 64 of them.  K and V load once by TMA (a 128-row box, as
// the main loop's Q) and stay.  The CTA lists the 64-position query tiles
// its live keys meet (list_live_tiles<DKV_BQ, true>); the producer warp
// walks that list and, per tile, the G query heads of the kv head: lane 0
// loads the Q and dO tiles (64 rows, 128B-swizzled, as dQ's K and V tiles)
// into a ring of DKV_STAGES stages, and the warp copies the tile's segment
// ids, lse (in log2 units; +inf for a query of segment 0 or past S, so its
// P is 0) and delta = rowsum(dO * O) (gathered from its (B, S, Hq) layout)
// beside them.  Per stage, each consumer warpgroup:
//   S^T = K Q^T and dP^T = V dO^T: 2 x 8 wgmma m64n64k16 from shared memory
//   (K and V as the A operand, K-major; Q and dO as B), one commit;
//   P^T = exp2(S^T scale log2(e) - lse log2(e)) on the live pairs, else 0,
//   and dS^T = P^T (dP^T - delta) scale, with dQ's interior test (only a
//   tile that meets the diagonal, the window edge or another segment masks
//   per score);
//   dV += bf16(P^T) dO and dK += bf16(dS^T) Q: 2 x 4 wgmma m64n128k16, A from
//   registers (S^T's accumulator layout is the A layout), dO and Q read
//   MN-major as dQ reads K.  P and dS are rounded to bf16 before their
//   products, dS from the unrounded P, as _bwd_dkv_kernel (:525, :535).
// dK and dV of all G heads accumulate in registers (64 + 64 f32 a consumer
// thread; setmaxnreg 40 / 232 as dQ: with 24 / 240 or 32 / 240 ptxas spills),
// so the GQA group sum stays in the kernel, in f32, rounded once.
// The plain version rounds each head first, as the reference sums its
// per-head outputs (flash_attention.py:738-741): GRAD_FLOOR covers the
// difference.  Shared memory: K 32 KB + V 32 KB + 4 stages x (Q 16 KB + dO
// 16 KB + 768 bytes of ids, lse, delta) + the tile list, 199 KB.  Keys of
// segment 0 store zeros, keys >= S nothing.  No atomics: every output row
// has one writer, so the result is deterministic.

constexpr int DKV_BQ = 64;                                     // queries per stage
constexpr int DKV_STAGES = 4;                                  // Q/dO ring depth
constexpr int DKV_SIDE_BYTES = 3 * DKV_BQ * 4;                 // a stage's ids, lse, delta
constexpr int DKV_OFF_K = 0;
constexpr int DKV_OFF_V = OPERAND_BYTES;
constexpr int DKV_OFF_Q = 2 * OPERAND_BYTES;                   // + stage * KV64_BYTES
constexpr int DKV_OFF_DO = DKV_OFF_Q + DKV_STAGES * KV64_BYTES;  // + stage * KV64_BYTES
constexpr int DKV_OFF_SIDE = DKV_OFF_DO + DKV_STAGES * KV64_BYTES;  // + stage * DKV_SIDE_BYTES
constexpr int DKV_OFF_LIST = DKV_OFF_SIDE + DKV_STAGES * DKV_SIDE_BYTES;
constexpr int DKV_OFF_BARS = DKV_OFF_LIST + TILE_LIST_BYTES;
// barriers (kv_full, full[4], empty[4]), list_live_tiles' 5 ints, alignment
constexpr int DKV_SMEM_BYTES = DKV_OFF_BARS + 128 + 1024;

template <int DMAX>  // 128: instantiated only where it is launched (flash_attention_sm90.cu)
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                      const Params p, bf16* dv_out) {
  static_assert(DMAX == WIDE, "dK/dV runs at the head-dim width 128");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_kv = base + DKV_OFF_BARS;
  const uint32_t bar_full = bar_kv + 8;                    // + 8 * stage
  const uint32_t bar_empty = bar_kv + 8 + 8 * DKV_STAGES;  // + 8 * stage
  int* scratch = reinterpret_cast<int*>(smem + DKV_OFF_BARS + 8 + 16 * DKV_STAGES);
  unsigned char* tile_flags = smem + DKV_OFF_LIST;
  short* tile_list = reinterpret_cast<short*>(tile_flags + MAX_TILES);

  const int b = blockIdx.z, h = blockIdx.y;  // h: the kv head
  const int j0 = blockIdx.x * BM;            // the CTA's first key
  const int G = p.G;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 2);  // the TMA bytes and the side values
      mbar_init(bar_empty + 8 * s, NCONSUMER);
    }
    scratch[0] = INT_MAX;
    scratch[1] = -1;
    scratch[2] = INT_MAX;
    scratch[3] = INT_MIN;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // K and V load while the CTA lists its query tiles
    mbar_expect_tx(bar_kv, 2 * OPERAND_BYTES);
    for (int a = 0; a < 2; ++a) {
      tma_load_4d(base + DKV_OFF_K + a * ATOM_BYTES, &tm_k, bar_kv, a * ATOM, h, j0, b);
      tma_load_4d(base + DKV_OFF_V + a * ATOM_BYTES, &tm_v, bar_kv, a * ATOM, h, j0, b);
    }
  }
  const int n_tiles = list_live_tiles<DKV_BQ, true>(p.seg + static_cast<long long>(b) * p.S, p.S, p.window, j0, BM,
                                                    scratch, tile_flags, tile_list);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    // lane 0 issues the TMA loads, the warp copies each stage's ids, lse
    // and delta (2 a lane)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lane = threadIdx.x;
    if (lane < 32) {
      const int* seg_row = p.seg + static_cast<long long>(b) * p.S;
      const float* lse_h = p.lse + (static_cast<long long>(b) * p.H + h * G) * p.S;  // + g * S + i
      const float* dlt_h = p.delta + static_cast<long long>(b) * p.S * p.H + h * G;  // + i * H + g
      int st = 0;
      uint32_t ph = 1;  // the first round passes at once
      for (int t = 0; t < n_tiles; ++t) {
        const int i0 = tile_list[t] * DKV_BQ;
        int ids[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + 2 * lane + u;
          ids[u] = i < p.S ? seg_row[i] : 0;
        }
        for (int g = 0; g < G; ++g) {
          const int hq = h * G + g;
          mbar_wait(bar_empty + 8 * st, ph);
          if (lane == 0) {
            mbar_expect_tx(bar_full + 8 * st, 2 * KV64_BYTES);
            for (int a = 0; a < 2; ++a) {
              tma_load_4d(base + DKV_OFF_Q + st * KV64_BYTES + a * ATOM64_BYTES, &tm_q, bar_full + 8 * st,
                          a * ATOM, hq, i0, b);
              tma_load_4d(base + DKV_OFF_DO + st * KV64_BYTES + a * ATOM64_BYTES, &tm_do, bar_full + 8 * st,
                          a * ATOM, hq, i0, b);
            }
          }
          float lse2[2], dlt[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = i0 + 2 * lane + u;
            lse2[u] = ids[u] != 0 ? lse_h[g * p.S + i] * LOG2E : INFINITY;
            dlt[u] = ids[u] != 0 ? dlt_h[static_cast<long long>(i) * p.H + g] : 0.f;
          }
          unsigned char* side = smem + DKV_OFF_SIDE + st * DKV_SIDE_BYTES;
          reinterpret_cast<int2*>(side)[lane] = make_int2(ids[0], ids[1]);
          reinterpret_cast<float2*>(side + DKV_BQ * 4)[lane] = make_float2(lse2[0], lse2[1]);
          reinterpret_cast<float2*>(side + 2 * DKV_BQ * 4)[lane] = make_float2(dlt[0], dlt[1]);
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_full + 8 * st);
          if (++st == DKV_STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;  // keys [64 cw, 64 cw + 64) of the CTA's 128
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r_lo = 64 * cw + 16 * warp + lane / 4;  // this thread's keys: r_lo and r_lo + 8
    const int cq = 2 * (lane % 4);                    // its first query column in each group of 8

    // position and segment of this thread's two keys; a key of segment 0 or
    // past S has position INT_MAX (no query is live for it) and stores zeros
    int kpos[2], ksid[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int j = j0 + r_lo + 8 * hr;
      ksid[hr] = j < p.S ? p.seg[static_cast<long long>(b) * p.S + j] : 0;
      kpos[hr] = ksid[hr] != 0 ? j : INT_MAX;
    }

    float dk[WIDE / 2], dv[WIDE / 2];
#pragma unroll
    for (int i = 0; i < WIDE / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }

    mbar_wait(bar_kv, 0);
    const uint32_t k_tile = base + DKV_OFF_K + cw * 64 * 128;  // 64 rows x 128 bytes into each atom
    const uint32_t v_tile = base + DKV_OFF_V + cw * 64 * 128;

    int st = 0;
    uint32_t ph = 0;
    for (int n = 0, t = 0, g = 0; n < n_tiles * G; ++n) {
      const int i0 = tile_list[t] * DKV_BQ;
      mbar_wait(bar_full + 8 * st, ph);
      const uint32_t q_tile = base + DKV_OFF_Q + st * KV64_BYTES;
      const uint32_t do_tile = base + DKV_OFF_DO + st * KV64_BYTES;

      // ---- S^T = K Q^T and dP^T = V dO^T: 8 k-steps of 16 columns each ----
      float s[DKV_BQ / 2], dp[DKV_BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WIDE / 16; ++kk) {
        const uint32_t ok = (kk / 4) * ATOM_BYTES + (kk % 4) * 32, oq = (kk / 4) * ATOM64_BYTES + (kk % 4) * 32;
        wgmma_m64n64k16_ss(s, sw128_desc(k_tile + ok, 1, 64), sw128_desc(q_tile + oq, 1, 64), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < WIDE / 16; ++kk) {
        const uint32_t ok = (kk / 4) * ATOM_BYTES + (kk % 4) * 32, oq = (kk / 4) * ATOM64_BYTES + (kk % 4) * 32;
        wgmma_m64n64k16_ss(dp, sw128_desc(v_tile + ok, 1, 64), sw128_desc(do_tile + oq, 1, 64), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // ---- is the tile interior for this thread's live keys? ----
      const unsigned char* side = smem + DKV_OFF_SIDE + st * DKV_SIDE_BYTES;
      const int* qseg = reinterpret_cast<const int*>(side);
      const float* lse2 = reinterpret_cast<const float*>(side + DKV_BQ * 4);
      const float* dlt = reinterpret_cast<const float*>(side + 2 * DKV_BQ * 4);
      const int2 ids = reinterpret_cast<const int2*>(qseg)[lane];
      const int qmin = __reduce_min_sync(0xffffffffu, min(ids.x, ids.y));
      const int qmax = __reduce_max_sync(0xffffffffu, max(ids.x, ids.y));
      bool interior = true;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (kpos[hr] != INT_MAX)
          interior = interior && qmin == ksid[hr] && qmax == ksid[hr] && i0 >= kpos[hr] &&
                     (p.window <= 0 || i0 + DKV_BQ - 1 - kpos[hr] < p.window);

      // ---- P^T on the live pairs, dS^T = P^T (dP^T - delta) scale ----
#pragma unroll
      for (int i = 0; i < DKV_BQ / 2; ++i) {
        const int hr = (i >> 1) & 1, c = 8 * (i / 4) + cq + (i & 1);
        float pr = exp2f(s[i] * p.scale_log2 - lse2[c]);
        if (!interior) {
          const int qi = i0 + c;
          const bool live = qseg[c] == ksid[hr] && kpos[hr] <= qi && (p.window <= 0 || qi - kpos[hr] < p.window);
          if (!live) pr = 0.f;
        }
        dp[i] = pr * (dp[i] - dlt[c]) * p.scale;
        s[i] = pr;
      }

      // ---- dV += P^T dO, dK += dS^T Q: 4 k-steps of 16 queries each ----
      uint32_t pa[DKV_BQ / 16][4], da[DKV_BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pa[kk][c] = pack_bf16(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
          da[kk][c] = pack_bf16(dp[8 * kk + 2 * c], dp[8 * kk + 2 * c + 1]);
        }
      wgmma_fence();
      // dO and Q MN-major: 8-query groups 1024 bytes apart (SBO), their two
      // 64-column atoms ATOM64_BYTES apart (LBO)
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_m64n128k16_rs(dv, pa[kk], sw128_desc(do_tile + kk * 16 * 128, ATOM64_BYTES / 16, 64));
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_m64n128k16_rs(dk, da[kk], sw128_desc(q_tile + kk * 16 * 128, ATOM64_BYTES / 16, 64));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(bar_empty + 8 * st);
      if (++st == DKV_STAGES) {
        st = 0;
        ph ^= 1;
      }
      if (++g == G) {  // the next query tile
        g = 0;
        ++t;
      }
    }

    // ---- epilogue: bf16 dK and dV into the contiguous (B, S, Hk, D) outputs ----
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = j0 + r_lo + 8 * hr;
      if (key < p.S) {
        const long long at = b * p.sob + key * p.sos + h * p.soh;
        const bool dead = kpos[hr] == INT_MAX;
#pragma unroll
        for (int j = 0; j < WIDE / 8; ++j) {
          const int col = 8 * j + cq;
          if (col < p.D) {
            *reinterpret_cast<__nv_bfloat162*>(p.out + at + col) =
                dead ? __floats2bfloat162_rn(0.f, 0.f)
                     : __floats2bfloat162_rn(dk[4 * j + 2 * hr], dk[4 * j + 2 * hr + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dv_out + at + col) =
                dead ? __floats2bfloat162_rn(0.f, 0.f)
                     : __floats2bfloat162_rn(dv[4 * j + 2 * hr], dv[4 * j + 2 * hr + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reach it through the
// runtime's entry-point query, so the library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// a (B, S, H, D) bf16 tensor with element strides (sb, ss, sh, 1) as a 4-D
// map {D, H, S, B}; boxes of 64 columns x box_h heads x box_s rows (128 rows
// of 128 bytes in all), 128B-swizzled, zeros past every edge
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, long long sb,
                            long long ss, long long sh, int box_h = 1, int box_s = BM) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {ATOM, static_cast<cuuint32_t>(box_h), static_cast<cuuint32_t>(box_s), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Operand {
  const void* ptr;
  long long sb, ss, sh;
};

template <int DMAX, int MODE>
cudaError_t launch_kernel(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
                          dim3 grid, cudaStream_t stream) {
  auto kern = attention_sm90_kernel<DMAX, MODE>;
  constexpr int bytes = smem_bytes(MODE);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, NTHREADS, bytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// K1 and K5: q, k, v (B, S, H, D) through their strides, D % 8 == 0 and D <= 80; K1
// (NO_BIAS) also takes 80 < D <= 128 on the WIDE form (InternViT-6B's 128), whose
// O and S fill the consumers' registers as K2's do and whose shared memory is
// K2's less the segment ids
template <int MODE>
cudaError_t launch(Operand q, Operand k, Operand v, Params p, int B, cudaStream_t stream) {
  constexpr int dmax = MODE == NO_BIAS ? WIDE : NARROW;
  if (p.D <= 0 || p.D % 8 != 0 || p.D > dmax || p.S <= 0 || p.kv_len <= 0 || p.kv_len > p.S)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q.ptr, B, p.S, p.H, p.D, q.sb, q.ss, q.sh);
  if (err == cudaSuccess) err = make_map(&tk, k.ptr, B, p.S, p.H, p.D, k.sb, k.ss, k.sh);
  if (err == cudaSuccess) err = make_map(&tv, v.ptr, B, p.S, p.H, p.D, v.sb, v.ss, v.sh);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BM - 1) / BM, p.H, B);
  if constexpr (MODE == NO_BIAS) {
    if (p.D > NARROW) return launch_kernel<WIDE, MODE>(tq, tk, tv, p, grid, stream);
  }
  return launch_kernel<NARROW, MODE>(tq, tk, tv, p, grid, stream);
}

}  // namespace sm90
}  // namespace srgpt

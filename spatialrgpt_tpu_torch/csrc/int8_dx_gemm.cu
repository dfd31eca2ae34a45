// K11: the int8 product of the SwitchBack dx of a W8A8 projection.
//
// Replaces the product and epilogue of spatialrgpt_tpu/ops/layers.py::
// _w8a8_dot_bwd's int8 route (XLA in the reference, layers.py:74-78):
//   acc = dyq . q  (int8 (M, N) x int8 (N, K) -> int32, exact),
//   dx = bf16( f32(acc) * gscale[m] ).
// dyq and gscale are K10's (csrc/act_quant.cu); q is the projection's weight
// as the port stores it, (out, in) = (N, K) row-major, read as stored: the
// product contracts over q's rows, its output axis.  No transposed copy of
// the weight exists anywhere (one int8 copy is the memory contract of the
// path).
//
// Bound on the H100: int8 operations (the align step's gate / up dx, M 16,384
// x N 14,336 -> K 4096: 1.92 TOP, 0.97 ms at 1,979 TOP/s).
//
// Design: wgmma m64n128k32 s8 x s8 -> s32 from shared memory, whose s8 form
// takes B only K-major, i.e. with the contracted axis contiguous.  dyq is
// K-major already; q's tile is not, so the CTA transposes it in shared
// memory.  A CTA computes 128 x 128 outputs, one 64-row half per warpgroup
// (two warpgroups), over stages of 128 contracted bytes:
//   - cp.async brings dyq's 128 x 128-byte tile into the 128B-swizzled
//     K-major layout that wgmma reads (the swizzle applied to the
//     destination address) and q's raw 128 (contracted) x 128 (output)
//     tile as it is, into a ring of 4 stages, two tiles ahead;
//   - every warp transposes 16 contracted rows of the raw tile: a lane
//     reads 16 4-byte words (4 output columns of each row, neighbouring
//     lanes on neighbouring words), transposes them in registers (byte
//     permutes, 4 x 4 at a time) and writes its 4 columns' 16 contracted
//     bytes as 16-byte stores into a 128B-swizzled K-major tile; each lane
//     starts at another column, so that the 8 lanes of a store phase hit 8
//     distinct 16-byte chunks (no bank conflict on either side);
//   - the transposed tile is double-buffered, so stage kt + 1's transpose
//     runs while stage kt's wgmma does;
//   - the CTAs walk the output tiles in groups of 8 row tiles, so those in
//     flight share their panels of dyq and q in L2.
// The epilogue is the reference's: __int2float_rn, one rounded multiply by
// gscale, one rounding to bf16; the int32 sums are exact in any order, so
// K11 equals its plain version bit for bit.  Ragged M, K and the contracted
// tail are zero-filled.  N % 8 == 0 (the lm_head's 128,264 is not a multiple
// of 16: its rows of dyq are 8-byte aligned and arrive as 8-byte copies),
// K % 16 == 0, 16-byte aligned bases (the wrapper's rule).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace srgpt {
namespace dxgemm {

using sm90::smem_u32;
using sm90::sw128_desc;
using sm90::wgmma_commit;
using sm90::wgmma_fence;

constexpr int BM = 128;       // rows of dx per CTA: one warpgroup each 64
constexpr int BN = 128;       // columns of dx per CTA (q's columns)
constexpr int BK = 128;       // contracted bytes per stage: one 128-byte swizzle atom
constexpr int STAGES = 4;     // ring of dyq + raw q tiles; loads run two stages ahead
constexpr int THREADS = 256;  // two warpgroups
constexpr int TILE = 128 * 128;                                // every tile: 128 rows of 128 bytes
constexpr int SMEM = STAGES * 2 * TILE + 2 * TILE + 1024;      // ring, 2 transposed tiles, 1024 to align
constexpr int GROUP_M = 8;    // row tiles per group of the raster order

// tile -> (row tile, column tile): groups of GROUP_M row tiles, each walked
// column tile by column tile, row tiles fastest, so that the CTAs in flight
// share their dyq row panels and q column panels in L2 (at the gate / up dx
// a panel is 1.8 MB; q alone is 58.7 MB, past the 50 MB L2)
__device__ __forceinline__ void tile_coords(int tile, int tiles_m, int tiles_n, int& mb, int& nb) {
  const int group_size = GROUP_M * tiles_n, first_m = (tile / group_size) * GROUP_M;
  const int gm = min(tiles_m - first_m, GROUP_M), in_group = tile % group_size;
  mb = first_m + in_group % gm;
  nb = in_group / gm;
}

// VEC (16 or 8) bytes global -> shared, zero-filled when !valid (src-size 0)
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads of the accumulator across the wait
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 128, s32, registers) (+)= A (64 x 32, int8, shared, K-major) * B (32 x 128, int8, shared, K-major)
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// stage s of the ring: dyq's swizzled tile, then q's raw tile
__device__ __forceinline__ unsigned char* a_tile(unsigned char* smem, int s) { return smem + s * 2 * TILE; }
__device__ __forceinline__ unsigned char* raw_tile(unsigned char* smem, int s) { return smem + s * 2 * TILE + TILE; }

// contracted bytes kc0..kc0+127 of dyq's rows m0..m0+127 (row r's 16-byte
// chunk c at chunk c ^ (r % 8), wgmma's 128B swizzle) and of q's rows
// kc0..kc0+127, columns n0..n0+127, as they are
template <int VEC>
__device__ __forceinline__ void load_stage(unsigned char* smem, int s, const int8_t* __restrict__ dyq,
                                           const int8_t* __restrict__ q, int M, int N, int K, int m0, int n0,
                                           int kc0) {
  const uint32_t a = smem_u32(a_tile(smem, s)), raw = smem_u32(raw_tile(smem, s));
  constexpr int PER_ROW = BK / VEC;
#pragma unroll
  for (int i = 0; i < BM * PER_ROW / THREADS; ++i) {
    const int id = threadIdx.x + i * THREADS, r = id / PER_ROW, piece = id % PER_ROW;
    const int m = m0 + r, k = kc0 + VEC * piece;
    const bool valid = m < M && k < N;
    const int chunk = (VEC * piece) / 16, within = (VEC * piece) % 16;
    cp_async<VEC>(a + r * 128 + ((chunk ^ (r & 7)) << 4) + within,
                  valid ? dyq + static_cast<long long>(m) * N + k : dyq, valid);
  }
#pragma unroll
  for (int i = 0; i < BK * 8 / THREADS; ++i) {
    const int id = threadIdx.x + i * THREADS, r = id / 8, c = id % 8;
    const int row = kc0 + r, col = n0 + 16 * c;
    const bool valid = row < N && col < K;
    cp_async<16>(raw + r * 128 + 16 * c, valid ? q + static_cast<long long>(row) * K + col : q, valid);
  }
}

// rows r[0..3] of 4 bytes (4 columns each) -> column e's 4 bytes of the 4 rows
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t (&col)[4]) {
  const uint32_t t01lo = __byte_perm(r[0], r[1], 0x5140);  // r0c0 r1c0 r0c1 r1c1
  const uint32_t t01hi = __byte_perm(r[0], r[1], 0x7362);  // r0c2 r1c2 r0c3 r1c3
  const uint32_t t23lo = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t23hi = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(t01lo, t23lo, 0x5410);
  col[1] = __byte_perm(t01lo, t23lo, 0x7632);
  col[2] = __byte_perm(t01hi, t23hi, 0x5410);
  col[3] = __byte_perm(t01hi, t23hi, 0x7632);
}

// warp w transposes contracted rows 16w..16w+15 of the raw tile; lane l
// owns output columns 4l..4l+3 and writes each one's 16 contracted bytes
// (one 16-byte chunk) into row 4l + e of the K-major tile bt
__device__ __forceinline__ void transpose_stage(const unsigned char* raw, unsigned char* bt) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  uint32_t words[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) words[i] = *reinterpret_cast<const uint32_t*>(raw + (16 * w + i) * 128 + 4 * l);
  uint32_t cols[4][4];  // [row group g][column e]
#pragma unroll
  for (int g = 0; g < 4; ++g) transpose4(words + 4 * g, cols[g]);
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    // lanes 2i and 2i + 1 start at column i: the 8 lanes of a store phase
    // write 8 rows of distinct (row % 8), so 8 distinct swizzled chunks
    const int e = (step + (l >> 1)) & 3;
    const uint4 v = e == 0   ? make_uint4(cols[0][0], cols[1][0], cols[2][0], cols[3][0])
                    : e == 1 ? make_uint4(cols[0][1], cols[1][1], cols[2][1], cols[3][1])
                    : e == 2 ? make_uint4(cols[0][2], cols[1][2], cols[2][2], cols[3][2])
                             : make_uint4(cols[0][3], cols[1][3], cols[2][3], cols[3][3]);
    const int j = 4 * l + e;
    *reinterpret_cast<uint4*>(bt + j * 128 + ((w ^ (j & 7)) << 4)) = v;
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 1) dx_kernel(const int8_t* __restrict__ dyq, const int8_t* __restrict__ q,
                                                        const float* __restrict__ gscale,
                                                        __nv_bfloat16* __restrict__ dx, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~static_cast<uintptr_t>(1023));
  unsigned char* bt_base = smem + STAGES * 2 * TILE;
  int mb, nb;
  tile_coords(blockIdx.x, (M + BM - 1) / BM, (K + BN - 1) / BN, mb, nb);
  const int n0 = nb * BN, m0 = mb * BM;
  const int wg = threadIdx.x / 128;
  const int nkt = (N + BK - 1) / BK;

  int acc[64];  // written first by the products (scale-d 0): no other instruction defines it

#pragma unroll
  for (int t = 0; t < STAGES - 2; ++t) {
    if (t < nkt) load_stage<VEC>(smem, t, dyq, q, M, N, K, m0, n0, t * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 3>();  // this thread's copies of tile kt have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; every warpgroup's wgmma of tile kt - 2 is done
    if (kt + STAGES - 2 < nkt)
      load_stage<VEC>(smem, (kt + STAGES - 2) % STAGES, dyq, q, M, N, K, m0, n0, (kt + STAGES - 2) * BK);
    cp_async_commit();
    unsigned char* bt = bt_base + (kt & 1) * TILE;
    transpose_stage(raw_tile(smem, kt % STAGES), bt);
    fence_proxy_async();
    __syncthreads();  // the transposed tile is whole
    const uint32_t a = smem_u32(a_tile(smem, kt % STAGES)) + wg * 64 * 128, b = smem_u32(bt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8_n128(acc, sw128_desc(a + 32 * kk, 1, 64), sw128_desc(b + 32 * kk, 1, 64), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // tile kt - 1's products are done: its buffers may be refilled
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: rows g and g + 8 of the warp's 16, columns 2c and 2c + 1 of
  // each group of 8
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + 16 * warp + g + 8 * h;
    if (m >= M) continue;
    const float gs = gscale[m];
    __nv_bfloat16* row = dx + static_cast<long long>(m) * K;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * c;
      if (n >= K) continue;  // K % 16 == 0: n + 1 < K too
      const float y0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), gs);
      const float y1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), gs);
      *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

template <int VEC>
cudaError_t launch(const void* dyq, const void* q, const void* gscale, void* dx, int M, int N, int K,
                   cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(dx_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * ((K + BN - 1) / BN);
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  dx_kernel<VEC><<<static_cast<unsigned>(tiles), THREADS, SMEM, stream>>>(static_cast<const int8_t*>(dyq), static_cast<const int8_t*>(q),
                                                  static_cast<const float*>(gscale),
                                                  static_cast<__nv_bfloat16*>(dx), M, N, K);
  return cudaGetLastError();
}

}  // namespace dxgemm
}  // namespace srgpt

// K11: dyq (M, N) int8, q (N, K) int8, gscale (M,) f32 -> dx (M, K) bf16; N % 16 == 0
// takes 16-byte copies of dyq, else 8-byte ones
extern "C" int srgpt_int8_dx_gemm(const void* dyq, const void* q, const void* gscale, void* dx, int M, int N, int K,
                                  void* stream) {
  using namespace srgpt::dxgemm;
  if (M <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (N <= 0 || N % 8 != 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(N % 16 == 0 ? launch<16>(dyq, q, gscale, dx, M, N, K, st)
                                      : launch<8>(dyq, q, gscale, dx, M, N, K, st));
}

// K11: the int8 product of the SwitchBack dx of a W8A8 projection.
//
// Replaces the product and epilogue of spatialrgpt_tpu/ops/layers.py::
// _w8a8_dot_bwd's int8 route (XLA in the reference, layers.py:74-78):
//   acc = dyq . q  (int8 (M, N) x int8 (N, K) -> int32, exact),
//   dx = bf16( f32(acc) * gscale[m] ).
// dyq and gscale are K10's (csrc/act_quant.cu); q is the projection's weight
// as the port stores it, (out, in) = (N, K) row-major: the product contracts
// over q's rows, its output axis.
//
// Bound on the H100: int8 operations (the align step's gate / up dx, M 16,384
// x N 14,336 -> K 4096: 1.92 TOP, 0.97 ms at 1,979 TOP/s).
//
// Design: two launches a call.  s8 wgmma takes B only K-major, with the
// contracted axis contiguous, and q has its output axis contiguous.  So:
//   1. transpose_kernel writes qt = q^T, (K, N16) int8, N16 = N rounded up
//      to 16 (TMA's 16-byte row stride), into a workspace that the wrapper
//      allocates for this call alone and frees after it: no transposed copy
//      of the weight outlives the call, and none is cached (one int8 copy is
//      the memory contract of the path).  A CTA moves a 128 x 128 byte
//      tile: 16-byte loads of q's rows into shared memory (chunk c of row r
//      at chunk c ^ (r / 16 % 8)), then each thread gathers 4 bytes of 16
//      rows (no bank conflict), transposes 4 x 4 blocks in registers with
//      byte permutes and writes 16 bytes of 4 rows of qt; 8 lanes write a
//      128-byte run of one row.  Bound: 2 |q| / 3.35 TB/s, 35 us for a
//      decoder's 58.7 MB weight, 0.31 ms for the lm_head's 525 MB.
//   2. dx = dyq . qt^T is then TN, K8's large form (csrc/int8_gemm.cu,
//      launch_large_dx): persistent, 128 x 256 tiles, wgmma m64n256k32 s8,
//      a TMA ring of 4 stages, with an epilogue of the row scale alone.
// The int32 sums are exact in any order and the epilogue is the
// reference's (__int2float_rn, one rounded multiply by gscale, one rounding
// to bf16), so K11 equals its plain version bit for bit.  dyq's rows may be
// further apart than N (K10 writes them N16 apart where N % 16 != 0: the
// lm_head's 128,264); both tensor maps say N, so TMA reads zeros past it,
// whatever the padding holds.  Ragged M and K are zero-filled the same way.
// K % 16 == 0, 16-byte aligned bases (the wrapper's rule).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srgpt {
namespace qgemm {
// csrc/int8_gemm.cu
cudaError_t launch_large_dx(const void* dyq, long long ld_dyq, const void* qt, long long ld_qt, const float* gscale,
                            __nv_bfloat16* dx, int M, int N, int K, cudaStream_t stream);
}  // namespace qgemm

namespace dxgemm {

constexpr int T = 128;          // q rows (n) and columns (k) of a transpose tile
constexpr int T_THREADS = 256;

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

// grid (ceil(K / 128), ceil(N / 128)): qt[k][n] = q[n][k] for the CTA's tile;
// rows n >= N of qt's last tile (up to N16) get zeros
__global__ void __launch_bounds__(T_THREADS) transpose_kernel(const int8_t* __restrict__ q, int8_t* __restrict__ qt,
                                                              int N, int K, int N16) {
  __shared__ __align__(16) unsigned char tile[T * T];
  const int k0 = blockIdx.x * T, n0 = blockIdx.y * T;
  uint4 v[T * T / 16 / T_THREADS];
#pragma unroll
  for (int i = 0; i < T * T / 16 / T_THREADS; ++i) {
    const int id = threadIdx.x + i * T_THREADS, r = id / 8, c = id % 8;
    const int n = n0 + r, k = k0 + 16 * c;
    v[i] = n < N && k < K ? *reinterpret_cast<const uint4*>(q + static_cast<long long>(n) * K + k) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < T * T / 16 / T_THREADS; ++i) {
    const int id = threadIdx.x + i * T_THREADS, r = id / 8, c = id % 8;
    *reinterpret_cast<uint4*>(tile + r * T + ((c ^ ((r >> 4) & 7)) << 4)) = v[i];
  }
  __syncthreads();
  // lane l of warp w: qt rows k0 + 4a .. 4a + 3 (a = 4w + l / 8, q's 4-byte
  // word a), qt columns n0 + 16b .. 16b + 15 (b = l % 8, q's rows); the word
  // sits in chunk (a / 4) ^ b of row 16b + i, so a warp's 32 loads of one i
  // hit 32 banks
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, b = l % 8, a = 4 * w + l / 8;
  uint32_t words[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    words[i] = *reinterpret_cast<const uint32_t*>(tile + (16 * b + i) * T + (((a >> 2) ^ b) << 4) + 4 * (a & 3));
  uint32_t cols[4][4];  // [group of 4 q rows][byte e of the word: qt row 4a + e]
#pragma unroll
  for (int g = 0; g < 4; ++g) transpose4(words + 4 * g, cols[g]);
  const int n = n0 + 16 * b;
  if (n >= N16) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = k0 + 4 * a + e;
    if (k < K)
      *reinterpret_cast<uint4*>(qt + static_cast<long long>(k) * N16 + n) =
          make_uint4(cols[0][e], cols[1][e], cols[2][e], cols[3][e]);
  }
}

}  // namespace dxgemm
}  // namespace srgpt

inline cudaError_t launch_transpose(const void* q, void* qt, int N, int K, cudaStream_t stream) {
  using namespace srgpt::dxgemm;
  if (N <= 0 || K <= 0) return cudaGetLastError();
  if (K % 16 != 0 || (N + T - 1) / T > 65535) return cudaErrorInvalidValue;
  transpose_kernel<<<dim3((K + T - 1) / T, (N + T - 1) / T), T_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<int8_t*>(qt), N, K, (N + 15) / 16 * 16);
  return cudaGetLastError();
}

// K11's first launch alone: q (N, K) int8 -> qt (K, N16) int8 (tests and timing)
extern "C" int srgpt_int8_transpose(const void* q, void* qt, int N, int K, void* stream) {
  return static_cast<int>(launch_transpose(q, qt, N, K, static_cast<cudaStream_t>(stream)));
}

// K11: dyq (M, N) int8 with rows ld_dyq bytes apart (a multiple of 16, >= N),
// q (N, K) int8, gscale (M,) f32 -> dx (M, K) bf16; qt: the caller's (K, N16)
// int8 workspace.  Two launches: the transpose, then the product.
extern "C" int srgpt_int8_dx_gemm(const void* dyq, long long ld_dyq, const void* q, const void* gscale, void* qt,
                                  void* dx, int M, int N, int K, void* stream) {
  if (M <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (N <= 0 || K % 16 != 0 || ld_dyq < N || ld_dyq % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_transpose(q, qt, N, K, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(srgpt::qgemm::launch_large_dx(dyq, ld_dyq, qt, (N + 15) / 16 * 16,
                                                        static_cast<const float*>(gscale),
                                                        static_cast<__nv_bfloat16*>(dx), M, N, K, st));
}

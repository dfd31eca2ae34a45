// Shared tile machinery of the two prefill-shaped attention kernels
// (vit_attention.cu: K1, prefill_attention.cu: K2).
//
// One CTA of 4 warps owns BM = 64 query rows; each warp owns 16 of them.
// Key/value tiles of BN = 64 positions stream through shared memory; the
// head dim D is zero-padded to DP (a multiple of 16) in shared memory only,
// with masked loads -- device memory is read at its true width through the
// caller's (B, S, H, D) strides.  Products run on the tensor cores through
// WMMA 16x16x16 bf16 fragments with fp32 accumulation:
//   S = Q K^T  (fp32, staged in shared memory)
//   online softmax per row (fp32 max / sum, P rounded to bf16 before PV,
//   as the Pallas kernels cast P to the value dtype)
//   O = O * alpha + P V   (fp32 accumulator in shared memory)
// The caller-specific part (which rows map to which head and position, and
// which keys are live) is the Policy template argument.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace srgpt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // keys per tile
constexpr int NWARPS = 4;     // BM / 16
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = BN + 4;   // fp32 score row stride
constexpr int LDP = BN + 8;   // bf16 probability row stride

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Shared-memory carve-up for a padded head dim DP.
template <int DP>
struct Smem {
  static constexpr int LDQ = DP + 8;  // bf16 q/k/v row stride (skews banks)
  static constexpr int LDO = DP + 4;  // fp32 accumulator row stride
  static constexpr int q = 0;
  static constexpr int k = q + align128(BM * LDQ * 2);
  static constexpr int v = k + align128(BN * LDQ * 2);
  static constexpr int s = v + align128(BN * LDQ * 2);
  static constexpr int p = s + align128(BM * LDS * 4);
  static constexpr int o = p + align128(BM * LDP * 2);
  static constexpr int m = o + align128(BM * LDO * 4);
  static constexpr int l = m + align128(BM * 4);
  static constexpr int alpha = l + align128(BM * 4);
  static constexpr int rowmeta = alpha + align128(BM * 4);  // policy: 2 ints per row
  static constexpr int keymeta = rowmeta + align128(BM * 8);  // policy: 1 int per key
  static constexpr int bytes = keymeta + align128(BN * 4);
};

struct Strides {
  long long b, s, h;  // element strides of a (B, S, H, D) tensor; d-stride is 1
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy `rows` rows of D bf16 (D % 8 == 0) into a DP-wide smem tile, 16 bytes
// per thread per step; rows where row_src returns nullptr and columns >= D
// are zero-filled.
template <int DP, typename RowSrc>
__device__ __forceinline__ void load_tile(bf16* dst, int rows, int D, RowSrc row_src) {
  constexpr int LDQ = Smem<DP>::LDQ;
  constexpr int CH = DP / 8;  // 16-byte chunks per padded row
  for (int idx = threadIdx.x; idx < rows * CH; idx += NTHREADS) {
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    const bf16* src = row_src(r);
    if (src != nullptr && c < D) val = *reinterpret_cast<const uint4*>(src + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = val;
  }
}

// Policy interface (see vit_attention.cu / prefill_attention.cu):
//   __device__ void init_rows(int* rowmeta) const        -- fill per-row metadata
//   __device__ const bf16* q_row(const int* rowmeta, int r) const
//   __device__ int key_tile_begin() const, key_tile_end() const
//   __device__ const bf16* k_row(int j) const, v_row(int j) const   (j < S)
//   __device__ void init_keys(int* keymeta, int j0) const
//   __device__ bool live(const int* rowmeta, const int* keymeta, int r, int jj, int j) const
//   __device__ bf16* out_row(const int* rowmeta, int r) const       (nullptr: skip)
template <int DP, typename Policy>
__global__ void __launch_bounds__(NTHREADS)
attention_tile_kernel(Policy pol, int S, int D, float sm_scale) {
  using L = Smem<DP>;
  constexpr int LDQ = L::LDQ;
  constexpr int LDO = L::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);
  float* sA = reinterpret_cast<float*>(smem + L::alpha);
  int* rowmeta = reinterpret_cast<int*>(smem + L::rowmeta);
  int* keymeta = reinterpret_cast<int*>(smem + L::keymeta);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  pol.init_rows(rowmeta);
  for (int r = threadIdx.x; r < BM; r += NTHREADS) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  for (int idx = threadIdx.x; idx < BM * LDO; idx += NTHREADS) sO[idx] = 0.f;
  __syncthreads();
  load_tile<DP>(sQ, BM, D, [&](int r) { return pol.q_row(rowmeta, r); });

  const int t_begin = pol.key_tile_begin();
  const int t_end = pol.key_tile_end();
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * BN;
    __syncthreads();  // previous tile fully consumed (and sQ written)
    load_tile<DP>(sK, BN, D, [&](int jj) { return j0 + jj < S ? pol.k_row(j0 + jj) : nullptr; });
    load_tile<DP>(sV, BN, D, [&](int jj) { return j0 + jj < S ? pol.v_row(j0 + jj) : nullptr; });
    pol.init_keys(keymeta, j0);
    __syncthreads();

    // ---- S_w = Q_w K^T (16 x 64 per warp) ----
    const int r0 = warp * 16;
#pragma unroll
    for (int nb = 0; nb < BN / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kb = 0; kb < DP / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + r0 * LDQ + kb * 16, LDQ);
        wmma::load_matrix_sync(b, sK + (nb * 16) * LDQ + kb * 16, LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + r0 * LDS + nb * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // ---- online softmax over this warp's 16 rows ----
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int c0 = lane, c1 = lane + 32;
      const bool live0 = pol.live(rowmeta, keymeta, r, c0, j0 + c0);
      const bool live1 = pol.live(rowmeta, keymeta, r, c1, j0 + c1);
      const float s0 = sS[r * LDS + c0] * sm_scale;
      const float s1 = sS[r * LDS + c1] * sm_scale;
      const float mt = warp_max(fmaxf(live0 ? s0 : -INFINITY, live1 ? s1 : -INFINITY));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mt);
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p0 = live0 ? expf(s0 - m_new) : 0.f;
        p1 = live1 ? expf(s1 - m_new) : 0.f;
        alpha = expf(m_old - m_new);  // m_old = -inf -> 0
      }
      sP[r * LDP + c0] = __float2bfloat16(p0);
      sP[r * LDP + c1] = __float2bfloat16(p1);
      const float lsum = warp_sum(p0 + p1);
      if (lane == 0) {
        sL[r] = sL[r] * alpha + lsum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncwarp();
    for (int idx = lane; idx < 16 * DP; idx += 32) {
      const int r = r0 + idx / DP;
      sO[r * LDO + idx % DP] *= sA[r];
    }
    __syncwarp();

    // ---- O_w += P_w V ----
#pragma unroll
    for (int db = 0; db < DP / 16; ++db) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * LDO + db * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + r0 * LDP + kb * 16, LDP);
        wmma::load_matrix_sync(b, sV + (kb * 16) * LDQ + db * 16, LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sO + r0 * LDO + db * 16, acc, LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // ---- epilogue: O / l, zeros for rows with no live key ----
  constexpr int CH = DP / 8;
  for (int idx = threadIdx.x; idx < BM * CH; idx += NTHREADS) {
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    bf16* dst = pol.out_row(rowmeta, r);
    if (dst == nullptr || c >= D) continue;
    const float l = sL[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(sO[r * LDO + c + e] * inv);
    *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(vals);
  }
}

// Launch with the dynamic shared memory this DP needs.
template <int DP, typename Policy>
cudaError_t launch_tile(Policy pol, dim3 grid, int S, int D, float sm_scale, cudaStream_t stream) {
  auto kern = attention_tile_kernel<DP, Policy>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<DP>::bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, NTHREADS, Smem<DP>::bytes, stream>>>(pol, S, D, sm_scale);
  return cudaGetLastError();
}

// Dispatch a runtime head dim (D % 8 == 0) to a padded tile width.  Only the
// widths of the ported callers are built: 80 for SigLIP (D = 72) and 128 for
// Llama; a smaller D pads into the next of them.
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_dp(int D, Args... args) {
  if (D % 8 != 0 || D <= 0) return cudaErrorInvalidValue;
  if (D <= 80) return Launch<80>::run(args...);
  if (D <= 128) return Launch<128>::run(args...);
  return cudaErrorInvalidValue;
}

}  // namespace srgpt

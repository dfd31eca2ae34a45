// K4: the dK/dV kernel of FlashAttention-2's backward for packed-segment
// causal GQA with an optional sliding window (the training step's attention
// at S = 4096).  K4's forward and dQ kernels are flash_attention_sm90.cu.
//
// Replaces the Pallas kernel
// spatialrgpt_tpu/ops/flash_attention.py::_flash_bwd / _bwd_dkv_kernel.
//
// Bound on the H100: tensor-core FLOPs.  At the align step's shape (B = 4,
// S = 4096, Hq = 32, Hk = 8, D = 128, 4 packed samples of ~1000 tokens per
// row) the live causal x segment area is ~4 x 1000^2 / 2 per (b, head): dK/dV
// does ~2x the forward's ~136 GFLOP (0.27 ms at 989 TFLOP/s) against ~0.3
// GB of q/k/v/dO/lse/delta traffic, so its products belong on the tensor
// cores and whole tiles that the mask kills are never loaded.
//
// Design.  Masks are built in the kernel from the (B, S) segment ids: key j
// is live for query i iff seg[i] == seg[j] != 0, j <= i and (window <= 0 or
// i - j < window).  A pair of 64-row tiles whose segment-id ranges do not
// overlap is skipped before its operands are loaded (the Pallas
// cross-segment skip, flash_attention.py:133-145), tiles above the diagonal
// are never visited, and with a window the walk ends at the first q tile
// past the key tile's band (the band test of _interior_predicate, :66-80).
// One CTA per (64 keys, kv head, row) walks the live q tiles and, inside
// each, the G query heads of its kv head, accumulating dK and dV for all G
// heads in f32 shared memory, so the GQA group sum happens in the kernel
// (the Pallas version wrote (B, Hq, S, D) per-head buffers and summed them
// in XLA).  Each warp owns 16 keys:
//   S^T = K Q^T, P^T = exp(S^T * scale - lse) masked,
//   dV += bf16(P^T) dO, dP^T = V dO^T,
//   dS^T = P^T (dP^T - delta) * scale,  dK += bf16(dS^T) Q.
// delta = rowsum(dO * O) is a plain torch reduction in the wrapper.  P and
// dS are rounded to bf16 before their products, as in the Pallas kernels.
// Products are WMMA 16x16x16 bf16 with f32 accumulation (attention_tile.cuh);
// the head dim is padded to 128 in shared memory (D <= 128, D % 8 == 0).
// Any S is taken.

#include "attention_tile.cuh"

namespace srgpt {

__device__ __forceinline__ void warp_range(int lo, int hi, int& out_lo, int& out_hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  out_lo = lo;
  out_hi = hi;
}

// Segment-id range of 64 ids (every lane of the calling warp gets it).
__device__ __forceinline__ void seg_range64(const int* ids, int& lo, int& hi) {
  const int lane = threadIdx.x % 32;
  warp_range(min(ids[lane], ids[lane + 32]), max(ids[lane], ids[lane + 32]), lo, hi);
}

// A q tile and a key tile can hold a live pair only if their id ranges
// overlap and the q tile holds a nonzero id (exact for any id layout:
// equal ids imply overlapping ranges).
__device__ __forceinline__ bool ranges_meet(int qlo, int qhi, int klo, int khi) {
  return qlo <= khi && klo <= qhi && qhi > 0;
}

constexpr int DPB = 128;  // padded head dim
constexpr int LDQB = DPB + 8;  // bf16 operand row stride
constexpr int LDOB = DPB + 4;  // f32 accumulator row stride

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (B, Hq, S)
  const float* delta;  // (B, S, Hq)
  const int* seg;      // (B, S)
  bf16* dk;            // (B, S, Hk, D) contiguous
  bf16* dv;
  Strides sq, sk, sv, sdo;
  int S, Hq, Hk, D;
  int window;          // <= 0: none
  float scale;
};

// Shared memory of the dK/dV kernel: four bf16 operand tiles, two f32
// score tiles, two bf16 tiles of P / dS, two f32 accumulators, and 64-entry
// vectors of lse, delta and the two tiles' segment ids.
struct BwdSmem {
  static constexpr int tile = align128(BM * LDQB * 2);
  static constexpr int op0 = 0, op1 = tile, op2 = 2 * tile, op3 = 3 * tile;
  static constexpr int s = 4 * tile;
  static constexpr int dp = s + align128(BM * LDS * 4);
  static constexpr int p = dp + align128(BM * LDS * 4);
  static constexpr int ds = p + align128(BM * LDP * 2);
  static constexpr int acc0 = ds + align128(BM * LDP * 2);
  static constexpr int acc1 = acc0 + align128(BM * LDOB * 4);
  static constexpr int lse = acc1 + align128(BM * LDOB * 4);
  static constexpr int delta = lse + align128(BM * 4);
  static constexpr int qseg = delta + align128(BM * 4);
  static constexpr int kseg = qseg + align128(BM * 4);
  static constexpr int bytes = kseg + align128(BM * 4);
};

// C (16 x 64 f32, row stride LDS) = A (16 rows x DPB) . B^T, where B is 64
// rows x DPB; A and B are bf16 tiles of row stride LDQB.
__device__ __forceinline__ void mma_abt(const bf16* A, const bf16* B, float* C) {
#pragma unroll
  for (int nb = 0; nb < BN / 16; ++nb) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kb = 0; kb < DPB / 16; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, A + kb * 16, LDQB);
      wmma::load_matrix_sync(b, B + (nb * 16) * LDQB + kb * 16, LDQB);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + nb * 16, acc, LDS, wmma::mem_row_major);
  }
}

// C (16 x DPB f32, row stride LDOB) += A (16 x 64 bf16, row stride LDP) . B,
// where B is 64 rows x DPB bf16 of row stride LDQB.
__device__ __forceinline__ void mma_acc(const bf16* A, const bf16* B, float* C) {
#pragma unroll
  for (int db = 0; db < DPB / 16; ++db) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + db * 16, LDOB, wmma::mem_row_major);
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + kb * 16, LDP);
      wmma::load_matrix_sync(b, B + (kb * 16) * LDQB + db * 16, LDQB);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + db * 16, acc, LDOB, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void load_ids(int* dst, const int* seg, long long row_base, int p0, int S) {
  for (int r = threadIdx.x; r < BM; r += NTHREADS) dst[r] = p0 + r < S ? seg[row_base + p0 + r] : 0;
}

// 64 rows of one head from a (B, S, H, D) tensor, zero past S.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, Strides st, int b, int p0, int h,
                                          int S, int D) {
  load_tile<DPB>(dst, BM, D, [&](int r) {
    return p0 + r < S ? base + b * st.b + (p0 + r) * st.s + h * st.h : nullptr;
  });
}

// 64 rows of an f32 accumulator -> bf16 rows of a contiguous (B, S, H, D).
__device__ __forceinline__ void store_rows(bf16* out, const float* acc, int b, int p0, int h, int H, int S,
                                           int D) {
  constexpr int CH = DPB / 8;
  for (int idx = threadIdx.x; idx < BM * CH; idx += NTHREADS) {
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    if (p0 + r >= S || c >= D) continue;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(acc[r * LDOB + c + e]);
    bf16* dst = out + ((static_cast<long long>(b) * S + p0 + r) * H + h) * D + c;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
  }
}

__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(BwdArgs a) {
  using L = BwdSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::op0);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::op1);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::op2);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::op3);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sdK = reinterpret_cast<float*>(smem + L::acc0);
  float* sdV = reinterpret_cast<float*>(smem + L::acc1);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);
  int* sQseg = reinterpret_cast<int*>(smem + L::qseg);
  int* sKseg = reinterpret_cast<int*>(smem + L::kseg);

  const int S = a.S;
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int j0 = blockIdx.x * BN;
  const int G = a.Hq / a.Hk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's 16 keys
  const long long seg_base = static_cast<long long>(b) * S;

  for (int idx = threadIdx.x; idx < BN * LDOB; idx += NTHREADS) {
    sdK[idx] = 0.f;
    sdV[idx] = 0.f;
  }
  load_ids(sKseg, a.seg, seg_base, j0, S);
  load_rows(sK, a.k, a.sk, b, j0, hk, S, a.D);
  load_rows(sV, a.v, a.sv, b, j0, hk, S, a.D);
  __syncthreads();
  int klo, khi;
  seg_range64(sKseg, klo, khi);

  const int n_tiles = (S + BM - 1) / BM;
  // causal: only q tiles at or after this key tile hold live pairs; with a
  // window, only those whose first query lies within it of the tile's last key
  for (int t = blockIdx.x; t < n_tiles; ++t) {
    const int i0 = t * BM;
    if (a.window > 0 && i0 - (j0 + BN - 1) >= a.window) break;
    __syncthreads();  // the previous q tile is fully consumed
    load_ids(sQseg, a.seg, seg_base, i0, S);
    __syncthreads();
    int qlo, qhi;
    seg_range64(sQseg, qlo, qhi);
    if (!ranges_meet(qlo, qhi, klo, khi)) continue;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      if (g > 0) __syncthreads();  // the previous head's Q / dO are consumed
      load_rows(sQ, a.q, a.sq, b, i0, h, S, a.D);
      load_rows(sdO, a.dout, a.sdo, b, i0, h, S, a.D);
      for (int c = threadIdx.x; c < BM; c += NTHREADS) {
        const int i = i0 + c;
        sLse[c] = i < S ? a.lse[(static_cast<long long>(b) * a.Hq + h) * S + i] : 0.f;
        sDelta[c] = i < S ? a.delta[(seg_base + i) * a.Hq + h] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T over this warp's keys; P^T in f32 (sS) and bf16 (sP)
      mma_abt(sK + r0 * LDQB, sQ, sS + r0 * LDS);
      __syncwarp();
      for (int rr = 0; rr < 16; ++rr) {
        const int jj = r0 + rr;
        const int j = j0 + jj;
        const int sj = sKseg[jj];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const int si = sQseg[c];
          const bool live = si != 0 && si == sj && j <= i0 + c && (a.window <= 0 || i0 + c - j < a.window);
          const float p = live ? expf(sS[jj * LDS + c] * a.scale - sLse[c]) : 0.f;
          sS[jj * LDS + c] = p;
          sP[jj * LDP + c] = __float2bfloat16(p);
        }
      }
      __syncwarp();
      mma_acc(sP + r0 * LDP, sdO, sdV + r0 * LDOB);  // dV += P^T dO
      mma_abt(sV + r0 * LDQB, sdO, sDP + r0 * LDS);  // dP^T = V dO^T
      __syncwarp();
      for (int rr = 0; rr < 16; ++rr) {
        const int jj = r0 + rr;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const float ds = sS[jj * LDS + c] * (sDP[jj * LDS + c] - sDelta[c]) * a.scale;
          sDS[jj * LDP + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();
      mma_acc(sDS + r0 * LDP, sQ, sdK + r0 * LDOB);  // dK += dS^T Q
    }
  }
  __syncthreads();
  store_rows(a.dk, sdK, b, j0, hk, a.Hk, S, a.D);
  store_rows(a.dv, sdV, b, j0, hk, a.Hk, S, a.D);
}

bool shape_ok(int Hq, int Hk, int D) {
  return Hk > 0 && Hq % Hk == 0 && D > 0 && D % 8 == 0 && D <= DPB;
}

}  // namespace srgpt

extern "C" int srgpt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    const void* seg, void* dk, void* dv,
    int B, int S, int Hq, int Hk, int D,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sdb, long long sds, long long sdh,
    int window, float sm_scale, void* stream) {
  using namespace srgpt;
  if (!shape_ok(Hq, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.seg = static_cast<const int*>(seg);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.sq = {sqb, sqs, sqh};
  a.sk = {skb, sks, skh};
  a.sv = {svb, svs, svh};
  a.sdo = {sdb, sds, sdh};
  a.S = S;
  a.Hq = Hq;
  a.Hk = Hk;
  a.D = D;
  a.window = window;
  a.scale = sm_scale;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BN - 1) / BN, Hk, B);
  flash_bwd_dkv_kernel<<<grid, NTHREADS, BwdSmem::bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

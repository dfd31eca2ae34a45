// K3: one-token decode attention against the flat token-major int8 KV cache.
//
// Replaces the Pallas kernel
// spatialrgpt_tpu/ops/decode_attention.py::decode_attention_int8_flat (_decode_kernel).
//
// Bound on the H100: bytes of the int8 cache.  Per step and layer every
// live cache position is read once (2 * Hk * D int8 bytes + 2 * Hk fp32
// scales) for ~4 FLOPs per byte -- far below the ~295 FLOP/byte ridge, so
// the kernel's job is to stream the cache at full bandwidth with enough
// CTAs in flight (B = 8, C = 352, Hk = 8, D = 128: at most 5.9 MB, 1.8 us
// at 3.35 TB/s).  At that size a call is a chain of latencies more than a
// stream, so the design keeps the chain short.
//
// Design: one launch, one thread-block cluster of n CTAs (n <= 8, chosen
// by the wrapper from C) per (row, kv head).  Each CTA takes a contiguous
// share of the live positions (<= lengths[b]; the rest are never read) and
// issues cp.async copies of its whole K and V slabs (D bytes at row stride
// F = Hk * D) into shared memory before it computes anything: at the serve
// shape 176 positions x 256 bytes, 45 KB a CTA, all in flight at once.  A
// share longer than one slab (64 KB) streams K, then V, in slab-sized
// chunks.  cp.async rather than TMA: one 2-D box is at most 256 rows, the
// copies need no barrier, and D % 4 rows (the wrapper's rule) take 4-byte
// copies where 16-byte ones do not align.  Both products run on the tensor
// cores as mma.sync m16n8k16 (bf16 in, f32 sums): an int8 value and a
// bf16 P are exact in bf16, so the products are the plain version's.
//   Pass 1: S = K q^T, 16 positions x the n_rep (<= 8) query heads a tile
//   and warp, k over D in steps of 16 (q's B fragments stay in registers;
//   columns past D are zeros of q), times k_scale * D^-0.5, into shared
//   memory.  Each CTA's max per head goes to its shared memory; after a
//   cluster barrier every CTA reads all of them through distributed shared
//   memory: the row max.
//   P = bf16(exp(s - m_row) * v_scale), the reference's rounding
//   (decode_attention.py:124 rounds p * vs before PV; at the serve cache's
//   C = 352 its one block makes m the row max) and the plain version's; l
//   is the f32 sum of the unrounded exp.
//   Pass 2: O = P V, the n_rep heads (rows 8-15 of the tile zero) x 8
//   columns a tile, k over the positions; each warp owns its column tiles
//   over all positions, so no partial needs summing inside the CTA.
//   Reduce: each CTA stores its l and O partial into rank 0's shared
//   memory (the K slab, free after pass 1), a second cluster barrier, and
//   rank 0 sums, divides and stores bf16 (B, Hq, D).
// Within a 16-wide k step a thread's four k slots are four consecutive
// bytes (columns in pass 1, positions in pass 2), the same permutation on
// both operands, so one 32-bit load gives a row's A fragment.  No scratch
// in device memory and no second launch.  The block-diagonal Q and the (F,
// Hq) accumulator of the Pallas kernel were workarounds for the TPU's
// matrix unit and are not carried over.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace srgpt {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int DEC_THREADS = 512;       // 16 warps
constexpr int DEC_MAXREP = 8;          // query heads per kv head
constexpr int DEC_MAXD = 256;          // head dim
constexpr int DEC_MAXCLUSTER = 8;      // CTAs per (row, kv head): the portable cluster size
constexpr int DEC_MAX_SCORES = 16384;  // positions per CTA x n_rep: 64 KB of f32 scores
constexpr int DEC_SLAB_BYTES = 65536;  // one K or V slab in shared memory
constexpr int DEC_MAX_SMEM = 232448;   // the most a CTA may use
// the CTA's max per head, then rank 0's l [rank][head]
constexpr int DEC_ML_L = DEC_MAXREP;
constexpr int DEC_ML_BYTES = (DEC_MAXREP + DEC_MAXCLUSTER * DEC_MAXREP) * 4;

// Byte offsets in dynamic shared memory.  A cached row takes D (rounded
// up to 16) + 16 bytes, so the rows that a warp's lanes read fall in other
// banks; positions are counted in tiles of 16.
struct DecLayout {
  int stride, rows, per16;  // bytes per cached row; rows per slab; positions per CTA rounded up to 16
  int off_ks, off_vs, off_s, off_ml, off_k, off_v, bytes;
};

__host__ __device__ inline int dec_round16(int x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline DecLayout dec_layout(int per_cta, int n_rep, int D, int cluster) {
  DecLayout L;
  L.stride = dec_round16(D) + 16;
  L.per16 = dec_round16(per_cta);
  const int fit = DEC_SLAB_BYTES / L.stride / 16 * 16;
  L.rows = L.per16 < fit ? L.per16 : fit;
  L.off_ks = 0;                                 // k scales x D^-0.5 of the CTA's positions
  L.off_vs = L.off_ks + L.per16 * 4;            // their v scales
  L.off_s = L.off_vs + L.per16 * 4;             // scores (n_rep, per16), then P
  L.off_ml = L.off_s + n_rep * L.per16 * 4;     // max per head; rank 0: every CTA's l per head
  L.off_k = L.off_ml + DEC_ML_BYTES;            // K slab; rank 0: O partials
  const int slab = L.rows * L.stride, partials = cluster * n_rep * D * 4;
  L.off_v = L.off_k + (slab > partials ? slab : partials);
  L.bytes = L.off_v + L.rows * L.stride;
  return L;
}

__device__ __forceinline__ float dec_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dec_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// `rows` rows of D int8 at row stride F into shared memory rows of `stride`
// bytes, GRAN bytes a copy, all in flight; the caller commits the group
template <int GRAN>
__device__ __forceinline__ void dec_copy_rows(unsigned char* dst, const int8_t* src, int rows, int D, int F,
                                              int stride) {
  const int per_row = D / GRAN;
  const uint32_t d0 = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int idx = threadIdx.x; idx < rows * per_row; idx += DEC_THREADS) {
    const int r = idx / per_row, c = idx - r * per_row;
    const int8_t* s = src + static_cast<long long>(r) * F + c * GRAN;
    const uint32_t d = d0 + r * stride + c * GRAN;
    if constexpr (GRAN == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(s) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(s) : "memory");
  }
}

__device__ __forceinline__ void dec_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void dec_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 int8 in one word -> two bf16x2 (bytes 0-1, bytes 2-3); exact
__device__ __forceinline__ void dec_i8x4_bf16(int w, uint32_t& lo, uint32_t& hi) {
  __nv_bfloat162 l = __floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(w)),
                                           static_cast<float>(static_cast<int8_t>(w >> 8)));
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(w >> 16)),
                                           static_cast<float>(static_cast<int8_t>(w >> 24)));
  lo = *reinterpret_cast<uint32_t*>(&l);
  hi = *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t dec_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// C (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col)
__device__ __forceinline__ void dec_mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (n, Hk, B), clusters of (n, 1, 1)
template <int GRAN>
__global__ void __launch_bounds__(DEC_THREADS, 1)
decode_attention_kernel(const bf16* __restrict__ q,       // (B, Hq, D)
                        const int8_t* __restrict__ kq,    // (B, C, Hk * D)
                        const float* __restrict__ ks,     // (B, C, Hk)
                        const int8_t* __restrict__ vq,    // (B, C, Hk * D)
                        const float* __restrict__ vs,     // (B, C, Hk)
                        const int* __restrict__ lengths,  // (B,)
                        bf16* __restrict__ out,           // (B, Hq, D)
                        int C, int Hk, int D, int n_rep, int per_cta, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int Hq = Hk * n_rep, F = Hk * D;
  const DecLayout L = dec_layout(per_cta, n_rep, D, n);
  float* sks = reinterpret_cast<float*>(smem + L.off_ks);
  float* svs = reinterpret_cast<float*>(smem + L.off_vs);
  float* ss = reinterpret_cast<float*>(smem + L.off_s);
  float* sml = reinterpret_cast<float*>(smem + L.off_ml);  // [g]: the CTA's max; rank 0 [8 + 8 r + g]: CTA r's l
  unsigned char* sk = smem + L.off_k;
  unsigned char* sv = smem + L.off_v;
  float* partials = reinterpret_cast<float*>(sk);  // rank 0, after pass 1: CTA r's O at [r][g][D]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / 4, tig = lane % 4;  // the mma fragments' row / column group, and thread in it
  constexpr int NWARPS = DEC_THREADS / 32;

  // q's B fragments: head `group` of the kv head's n_rep, columns 16 kk +
  // 4 tig .. + 3 (zeros past D and for heads past n_rep); loaded first, as
  // nothing they need waits on lengths[b]
  const int ksteps = dec_round16(D) / 16;
  uint32_t qb[DEC_MAXD / 16][2];
#pragma unroll
  for (int kk = 0; kk < DEC_MAXD / 16; ++kk) {
    const int col = 16 * kk + 4 * tig;
    uint2 v = make_uint2(0u, 0u);
    if (kk < ksteps && group < n_rep && col < D)
      v = *reinterpret_cast<const uint2*>(q + (static_cast<long long>(b) * Hq + h * n_rep + group) * D + col);
    qb[kk][0] = v.x;
    qb[kk][1] = v.y;
  }

  // this CTA's share of the live positions [0, lengths[b]]
  const int n_live = max(0, min(lengths[b] + 1, C));
  const int share = (n_live + n - 1) / n;
  const int c_begin = min(rank * share, n_live);
  const int cnt = min(c_begin + share, n_live) - c_begin;  // <= per_cta
  const bool whole = cnt <= L.rows;
  const long long row0 = static_cast<long long>(b) * C + c_begin;
  const int8_t* kbase = kq + row0 * F + h * D;
  const int8_t* vbase = vq + row0 * F + h * D;

  // every load of the CTA in flight before the first use
  if (cnt > 0) {
    dec_copy_rows<GRAN>(sk, kbase, min(cnt, L.rows), D, F, L.stride);
    dec_commit();
    if (whole) {
      dec_copy_rows<GRAN>(sv, vbase, cnt, D, F, L.stride);
      dec_commit();
    }
  }
  for (int c = threadIdx.x; c < cnt; c += DEC_THREADS) {
    sks[c] = ks[(row0 + c) * Hk + h] * sm_scale;
    svs[c] = vs[(row0 + c) * Hk + h];
  }

  // ---- pass 1: S = K q^T, a tile of 16 positions x 8 heads a warp ----
  for (int c0 = 0; c0 < cnt; c0 += L.rows) {
    const int rows = min(L.rows, cnt - c0);
    if (c0 > 0) {
      __syncthreads();  // the previous chunk is consumed
      dec_copy_rows<GRAN>(sk, kbase + static_cast<long long>(c0) * F, rows, D, F, L.stride);
      dec_commit();
    }
    if (whole)
      dec_wait<1>();  // K has landed; V may still be in flight
    else
      dec_wait<0>();
    __syncthreads();
    for (int m0 = 16 * warp; m0 < rows; m0 += 16 * NWARPS) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* r_lo = sk + (m0 + group) * L.stride + 4 * tig;  // rows past `rows` are never stored
      const unsigned char* r_hi = r_lo + 8 * L.stride;
#pragma unroll
      for (int kk = 0; kk < DEC_MAXD / 16; ++kk) {
        if (kk < ksteps) {
          uint32_t a0, a1, a2, a3;
          dec_i8x4_bf16(*reinterpret_cast<const int*>(r_lo + 16 * kk), a0, a2);
          dec_i8x4_bf16(*reinterpret_cast<const int*>(r_hi + 16 * kk), a1, a3);
          dec_mma(acc, a0, a1, a2, a3, qb[kk][0], qb[kk][1]);
        }
      }
      // acc[e]: position m0 + group + 8 (e / 2), head 2 tig + e % 2
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = m0 + group + 8 * (e / 2), g = 2 * tig + e % 2;
        if (pos < rows && g < n_rep) ss[g * L.per16 + c0 + pos] = acc[e] * sks[c0 + pos];
      }
    }
  }
  __syncthreads();

  // ---- the row max: the CTA's per head, then the cluster's ----
  if (warp < n_rep) {
    float m = -INFINITY;
    for (int c = lane; c < cnt; c += 32) m = fmaxf(m, ss[warp * L.per16 + c]);
    m = dec_warp_max(m);
    if (lane == 0) sml[warp] = m;
  }
  cluster.sync();  // every CTA's max is in place, and every K slab is free
  if (warp < n_rep) {
    float m = -INFINITY;
    for (int r = 0; r < n; ++r) m = fmaxf(m, cluster.map_shared_rank(sml, r)[warp]);
    // ---- P = bf16(exp(s - m) * v_scale), l = sum of the unrounded exp ----
    float l = 0.f;
    for (int c = lane; c < cnt; c += 32) {
      const float e = expf(ss[warp * L.per16 + c] - m);
      l += e;
      ss[warp * L.per16 + c] = __bfloat162float(__float2bfloat16(e * svs[c]));
    }
    for (int c = cnt + lane; c < dec_round16(cnt); c += 32) ss[warp * L.per16 + c] = 0.f;  // the last tile's tail
    l = dec_warp_sum(l);
    if (lane == 0) cluster.map_shared_rank(sml, 0)[DEC_ML_L + DEC_MAXREP * rank + warp] = l;
  }

  // ---- pass 2: O = P V, a warp per tile of 8 columns, over all positions ----
  const int ntiles = (D + 7) / 8;
  float o[DEC_MAXD / 8 / NWARPS][4];
#pragma unroll
  for (int j = 0; j < DEC_MAXD / 8 / NWARPS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  if (whole) dec_wait<0>();
  __syncthreads();  // P in shared memory, V landed
  for (int c0 = 0; c0 < cnt; c0 += L.rows) {
    const int rows = min(L.rows, cnt - c0);
    if (!whole) {
      __syncthreads();  // the previous chunk is consumed
      dec_copy_rows<GRAN>(sv, vbase + static_cast<long long>(c0) * F, rows, D, F, L.stride);
      dec_commit();
      dec_wait<0>();
      __syncthreads();
    }
    for (int k0 = 0; k0 < rows; k0 += 16) {
      const int p0 = k0 + 4 * tig;  // this thread's four k slots: positions p0 .. p0 + 3
      uint32_t a0 = 0u, a2 = 0u;     // head `group`'s P (rows 8-15 of the tile are zero)
      if (group < n_rep) {
        const float4 pv = *reinterpret_cast<const float4*>(ss + group * L.per16 + c0 + p0);
        a0 = dec_pack(pv.x, pv.y);
        a2 = dec_pack(pv.z, pv.w);
      }
      const unsigned char* vr = sv + p0 * L.stride + group;
#pragma unroll
      for (int j = 0; j < DEC_MAXD / 8 / NWARPS; ++j) {
        const int nt = warp + NWARPS * j;
        if (nt < ntiles) {
          const unsigned char* v = vr + 8 * nt;  // column 8 nt + group
          const uint32_t b0 = dec_pack(static_cast<float>(static_cast<int8_t>(v[0])),
                                       static_cast<float>(static_cast<int8_t>(v[L.stride])));
          const uint32_t b1 = dec_pack(static_cast<float>(static_cast<int8_t>(v[2 * L.stride])),
                                       static_cast<float>(static_cast<int8_t>(v[3 * L.stride])));
          dec_mma(o[j], a0, 0u, a2, 0u, b0, b1);
        }
      }
    }
  }

  // ---- reduce: every CTA's O partial into rank 0, which sums and stores ----
  float* dst = cluster.map_shared_rank(partials, 0) + rank * n_rep * D;
#pragma unroll
  for (int j = 0; j < DEC_MAXD / 8 / NWARPS; ++j) {
    const int d = 8 * (warp + NWARPS * j) + 2 * tig;  // o[j][0..1]: head `group`, columns d, d + 1
    if (group < n_rep && d < D)
      *reinterpret_cast<float2*>(dst + group * D + d) = make_float2(o[j][0], o[j][1]);
  }
  cluster.sync();  // the partials are in rank 0; the other CTAs may leave
  if (rank != 0) return;
  for (int i = threadIdx.x; i < n_rep * D; i += DEC_THREADS) {
    const int g = i / D;
    float tot = 0.f, l = 0.f;
    for (int r = 0; r < n; ++r) {
      tot += partials[r * n_rep * D + i];
      l += sml[DEC_ML_L + DEC_MAXREP * r + g];
    }
    out[(static_cast<long long>(b) * Hq + h * n_rep) * D + i] = __float2bfloat16(l > 0.f ? tot / l : 0.f);
  }
}

template <int GRAN>
cudaError_t dec_launch(const DecLayout& L, int cluster, const void* q, const void* kq, const void* ks,
                       const void* vq, const void* vs, const void* lengths, void* out, int B, int C, int Hk, int D,
                       int n_rep, int per_cta, float sm_scale, cudaStream_t stream) {
  auto kern = decode_attention_kernel<GRAN>;
  static int smem_set = 48 * 1024;  // the most dynamic shared memory this instantiation was allowed
  if (L.bytes > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (err != cudaSuccess) return err;
    smem_set = L.bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, Hk, B);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const bf16*>(q), static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), C, Hk, D, n_rep, per_cta, sm_scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace srgpt

// cluster: CTAs per (row, kv head), 1-8; each takes ceil(C / cluster)
// positions at most, and their scores must fit DEC_MAX_SCORES
extern "C" int srgpt_decode_attention(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* lengths, void* out,
    int B, int C, int Hq, int Hk, int D, int cluster, float sm_scale, void* stream) {
  using namespace srgpt;
  if (B <= 0 || Hk <= 0 || Hq % Hk != 0 || Hq / Hk > DEC_MAXREP || D <= 0 || D % 4 != 0 || D > DEC_MAXD ||
      C <= 0 || cluster < 1 || cluster > DEC_MAXCLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_rep = Hq / Hk, per_cta = (C + cluster - 1) / cluster;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(kq) | reinterpret_cast<uintptr_t>(vq);
  if (per_cta * n_rep > DEC_MAX_SCORES || addr % 4 != 0 || reinterpret_cast<uintptr_t>(q) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = D % 16 == 0 && addr % 16 == 0;  // 16-byte copies
  const DecLayout L = dec_layout(per_cta, n_rep, D, cluster);
  if (L.bytes > DEC_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(wide ? dec_launch<16>(L, cluster, q, kq, ks, vq, vs, lengths, out, B, C, Hk, D, n_rep,
                                                per_cta, sm_scale, st)
                               : dec_launch<4>(L, cluster, q, kq, ks, vq, vs, lengths, out, B, C, Hk, D, n_rep,
                                               per_cta, sm_scale, st));
}

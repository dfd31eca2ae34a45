// K8 and K9: the two products of the quantized projections, with the
// per-channel scale (and the bias) in the epilogue.
//
// K8 (srgpt_w8a8_gemm) replaces spatialrgpt_tpu/ops/layers.py::_w8a8_dot's
// product and epilogue (XLA in the reference, layers.py:36-41, then the
// bias of linear, layers.py:144-146):
//   acc = xq . q^T  (int8 x int8 -> int32, exact),
//   y = bf16( f32(acc) * (ascale[m] * scale[n]) (+ f32 bias[n]) ).
// K9 (srgpt_w8_gemm) replaces linear's int8 weight-only branch
// (layers.py:123-125): the weight is converted to bf16 in registers (exact:
// |q| <= 127), y = bf16( (x . q^T in f32) * scale[n] (+ f32 bias[n]) ).
//
// Both operands are K-major: xq / x (M, K) row-major and q (N, K) row-major,
// the port's (out, in) weight, which is what the int8 tensor-core products
// take (the reference's (din, dout) layout never reaches the card).
//
// Bound on the H100: operations for K8 at prefill and tower shapes (gate
// 20,480 x 4096 x 14,336: 2.41 TOP, 1.22 ms at 1,979 int8 TOP/s); bytes of
// the weight at decode, M = 64 (lm_head 4096 -> 128,264: 525 MB, 157 us at
// 3.35 TB/s; K9's down 14,336 -> 4096: 58.7 MB, 17.5 us).
//
// Design (a first, simple kernel; the Hopper TMA + wgmma redesign is later
// work): CTA tiles of 128 x 128 (8 warps of 64 x 32) for M > 64 and 64 x 128
// (8 warps of 32 x 32) for M <= 64, k in stages of 64 elements, a ring of 4
// stages filled by cp.async (16-byte copies; rows past M or N and the K
// tail are zero-filled through the copy's source size, and a zero adds
// nothing to a sum), mma.sync on the tensor cores: m16n8k32 s8 x s8 -> s32
// for K8, m16n8k16 bf16 x bf16 -> f32 for K9.  Within one k step a thread's
// fragment slots are consecutive bytes of a row in shared memory, the same
// permutation of k on both operands, so one 8-byte load gives two A (or
// both B) registers and a row of a tile is read without bank conflicts
// (rows padded by 32 or 16 bytes).  K8's integer sums are exact in any
// order, so K8 equals its plain version bit for bit: the epilogue keeps the
// reference's order with explicit round-to-nearest operations
// (__int2float_rn, __fmul_rn, __fadd_rn: no contraction into an FMA).  K9's
// f32 sums run in the tensor core's order.  K % 16 == 0 (16-byte rows).
// At decode (M <= 64) a weight of few column tiles would leave most SMs
// idle (K9's k/v: 8 tiles), so k is split until ~2 waves of CTAs stream
// the weight; the last CTA of a tile sums the splits (see qg_splits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace srgpt {

using bf16 = __nv_bfloat16;

constexpr int QG_BK = 64;      // k elements per stage
constexpr int QG_STAGES = 4;   // stages in the ring
constexpr int QG_B_ROW = QG_BK;  // bytes of one q row of a stage

// bytes of a row of a stage in shared memory: A (int8 or bf16) and q
__host__ __device__ constexpr int qg_a_stride(bool a8) { return (a8 ? QG_BK : 2 * QG_BK) + 32; }
__host__ __device__ constexpr int qg_b_stride(bool a8) { return QG_B_ROW + (a8 ? 32 : 16); }
__host__ __device__ constexpr int qg_stage_bytes(bool a8, int BM, int BN) {
  return BM * qg_a_stride(a8) + BN * qg_b_stride(a8);
}

__device__ __forceinline__ void qg_cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void qg_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void qg_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two int8 (bytes 0-1 of w) -> bf16x2, exact
__device__ __forceinline__ uint32_t qg_i8x2_bf16(uint32_t w) {
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(w & 0xff)),
                                           static_cast<float>(static_cast<int8_t>((w >> 8) & 0xff)));
  return *reinterpret_cast<uint32_t*>(&h);
}

// the epilogue of one output: K8 f32(acc) * (ascale * scale), K9 acc *
// scale, then the f32 bias, each rounded once (no contraction into an FMA)
template <bool A8, typename Acc>
__device__ __forceinline__ float qg_out(Acc v, float as, const float* __restrict__ scale,
                                        const void* __restrict__ bias, int bias_kind, int c) {
  float y;
  if constexpr (A8)
    y = __fmul_rn(__int2float_rn(v), __fmul_rn(as, scale[c]));
  else
    y = __fmul_rn(v, scale[c]);
  if (bias_kind == 1)
    y = __fadd_rn(y, __bfloat162float(static_cast<const bf16*>(bias)[c]));
  else if (bias_kind == 2)
    y = __fadd_rn(y, static_cast<const float*>(bias)[c]);
  return y;
}

// the last CTA of a split tile: sums the splits' partials of its BM x BN
// tile in split order, 4 consecutive columns a thread (16-byte loads from
// L2 when N % 4 == 0), every split's loads in flight together, then the
// epilogue
template <bool A8, int BM, int BN, int THREADS, typename Acc>
__device__ __forceinline__ void qg_reduce_store(const Acc* part, long long plane, int splits, int m0, int n0, int M,
                                                int N, const float* __restrict__ ascale,
                                                const float* __restrict__ scale, const void* __restrict__ bias,
                                                int bias_kind, bf16* __restrict__ out) {
  using V = typename std::conditional<A8, int4, float4>::type;
  constexpr int PER = BM * BN / (THREADS * 4);
  const bool vec = (N & 3) == 0;
  Acc s[PER][4];
#pragma unroll
  for (int p = 0; p < PER; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[p][i] = 0;
  for (int z = 0; z < splits; ++z) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = (p * THREADS + static_cast<int>(threadIdx.x)) * 4;
      const int row = m0 + e / BN, col = n0 + e % BN;
      if (row >= M || col >= N) continue;
      const Acc* src = part + z * plane + static_cast<long long>(row) * N + col;
      if (vec) {
        const V v = __ldcg(reinterpret_cast<const V*>(src));
        s[p][0] += v.x;
        s[p][1] += v.y;
        s[p][2] += v.z;
        s[p][3] += v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (col + i < N) s[p][i] += __ldcg(src + i);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int e = (p * THREADS + static_cast<int>(threadIdx.x)) * 4;
    const int row = m0 + e / BN, col = n0 + e % BN;
    if (row >= M) continue;
    const float as = A8 ? ascale[row] : 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < N)
        out[static_cast<long long>(row) * N + col + i] =
            __float2bfloat16_rn(qg_out<A8>(s[p][i], as, scale, bias, bias_kind, col + i));
  }
}

template <bool A8, int BM, int BN, int WM, int WN, bool SPLIT>
__global__ void __launch_bounds__(32 * WM * WN)
quant_gemm_kernel(const void* __restrict__ a, const int8_t* __restrict__ b, const float* __restrict__ ascale,
                  const float* __restrict__ scale, const void* __restrict__ bias, int bias_kind,
                  bf16* __restrict__ out, int M, int N, int K, int kt_per_split, void* __restrict__ work,
                  int* __restrict__ counters) {
  constexpr int THREADS = 32 * WM * WN;
  constexpr int WTM = BM / WM, WTN = BN / WN, MT = WTM / 16, NT = WTN / 8;
  constexpr int ESIZE = A8 ? 1 : 2;                  // bytes of an A element
  constexpr int A_CHUNKS = QG_BK * ESIZE / 16;       // 16-byte copies per A row of a stage
  constexpr int B_CHUNKS = QG_B_ROW / 16;
  constexpr int A_STRIDE = qg_a_stride(A8), B_STRIDE = qg_b_stride(A8);
  constexpr int A_BYTES = BM * A_STRIDE, STAGE = qg_stage_bytes(A8, BM, BN);
  using Acc = typename std::conditional<A8, int, float>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  // this CTA's k tiles: all of them, or split blockIdx.z's share
  const int kt0 = blockIdx.z * kt_per_split;
  const int KT = min((K + QG_BK - 1) / QG_BK, kt0 + kt_per_split) - kt0;
  const unsigned char* A = static_cast<const unsigned char*>(a);

  auto load = [&](int kt, int slot) {
    const uint32_t base = s0 + slot * STAGE;
#pragma unroll
    for (int i = threadIdx.x; i < BM * A_CHUNKS; i += THREADS) {
      const int r = i / A_CHUNKS, c = i % A_CHUNKS;
      const int gm = m0 + r, k = (kt0 + kt) * QG_BK + c * (16 / ESIZE);
      const bool ok = gm < M && k < K;
      const unsigned char* src = A + (ok ? (static_cast<long long>(gm) * K + k) * ESIZE : 0);
      qg_cp_async16(base + r * A_STRIDE + c * 16, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = threadIdx.x; i < BN * B_CHUNKS; i += THREADS) {
      const int r = i / B_CHUNKS, c = i % B_CHUNKS;
      const int gn = n0 + r, k = (kt0 + kt) * QG_BK + c * 16;
      const bool ok = gn < N && k < K;
      const int8_t* src = b + (ok ? static_cast<long long>(gn) * K + k : 0);
      qg_cp_async16(base + A_BYTES + r * B_STRIDE + c * 16, src, ok ? 16 : 0);
    }
  };

  Acc acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < QG_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    qg_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    qg_wait<QG_STAGES - 2>();
    __syncthreads();
    const int nk = kt + QG_STAGES - 1;
    if (nk < KT) load(nk, nk % QG_STAGES);
    qg_commit();

    const unsigned char* sa = smem + (kt % QG_STAGES) * STAGE + (wm * WTM + g) * A_STRIDE;
    const unsigned char* sb = smem + (kt % QG_STAGES) * STAGE + A_BYTES + (wn * WTN + g) * B_STRIDE;
    if constexpr (A8) {
#pragma unroll
      for (int kk = 0; kk < QG_BK; kk += 32) {  // bytes 8t..8t+7 of each 32-byte k step
        uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint2 lo = *reinterpret_cast<const uint2*>(sa + mt * 16 * A_STRIDE + kk + 8 * t);
          const uint2 hi = *reinterpret_cast<const uint2*>(sa + (mt * 16 + 8) * A_STRIDE + kk + 8 * t);
          af[mt][0] = lo.x; af[mt][1] = hi.x; af[mt][2] = lo.y; af[mt][3] = hi.y;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 w = *reinterpret_cast<const uint2*>(sb + nt * 8 * B_STRIDE + kk + 8 * t);
          bfr[nt][0] = w.x; bfr[nt][1] = w.y;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            asm volatile(
                "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                "{%0,%1,%2,%3};\n"
                : "+r"(acc[mt][nt][0]), "+r"(acc[mt][nt][1]), "+r"(acc[mt][nt][2]), "+r"(acc[mt][nt][3])
                : "r"(af[mt][0]), "r"(af[mt][1]), "r"(af[mt][2]), "r"(af[mt][3]), "r"(bfr[nt][0]),
                  "r"(bfr[nt][1]));
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < QG_BK; kk += 16) {  // elements 4t..4t+3 of each 16-wide k step
        uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint2 lo = *reinterpret_cast<const uint2*>(sa + mt * 16 * A_STRIDE + (kk + 4 * t) * 2);
          const uint2 hi = *reinterpret_cast<const uint2*>(sa + (mt * 16 + 8) * A_STRIDE + (kk + 4 * t) * 2);
          af[mt][0] = lo.x; af[mt][1] = hi.x; af[mt][2] = lo.y; af[mt][3] = hi.y;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(sb + nt * 8 * B_STRIDE + kk + 4 * t);
          bfr[nt][0] = qg_i8x2_bf16(w);
          bfr[nt][1] = qg_i8x2_bf16(w >> 16);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                "{%0,%1,%2,%3};\n"
                : "+f"(acc[mt][nt][0]), "+f"(acc[mt][nt][1]), "+f"(acc[mt][nt][2]), "+f"(acc[mt][nt][3])
                : "r"(af[mt][0]), "r"(af[mt][1]), "r"(af[mt][2]), "r"(af[mt][3]), "r"(bfr[nt][0]),
                  "r"(bfr[nt][1]));
      }
    }
  }

  // split k: each split stores its partial sums; the tile's last CTA to
  // arrive (a counter per tile, reset by it for the next launch) sums them
  // in split order -- exact for K8's int32, the same order in every run
  // for K9's f32 -- and runs the epilogue
  if constexpr (SPLIT) {
    if (gridDim.z > 1) {
      const long long plane = static_cast<long long>(M) * N;
      Acc* part = static_cast<Acc*>(work);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm * WTM + mt * 16 + g + half * 8;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = n0 + wn * WTN + nt * 8 + 2 * t + j;
              if (row < M && col < N)
                part[blockIdx.z * plane + static_cast<long long>(row) * N + col] = acc[mt][nt][half * 2 + j];
            }
        }
      __threadfence();
      __syncthreads();
      __shared__ int is_last;
      if (threadIdx.x == 0) {
        int* ctr = counters + blockIdx.y * gridDim.x + blockIdx.x;
        is_last = atomicAdd(ctr, 1) == static_cast<int>(gridDim.z) - 1;
        if (is_last) *ctr = 0;
      }
      __syncthreads();
      if (!is_last) return;
      __threadfence();
      qg_reduce_store<A8, BM, BN, THREADS>(part, plane, gridDim.z, m0, n0, M, N, ascale, scale, bias, bias_kind,
                                           out);
      return;
    }
  }

  // epilogue: rows g and g + 8 of each 16-row tile, columns 2t and 2t + 1
  // of each 8-column tile
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * WTM + mt * 16 + g + half * 8;
      if (row >= M) continue;
      const float as = A8 ? ascale[row] : 1.0f;
      bf16* orow = out + static_cast<long long>(row) * N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * WTN + nt * 8 + 2 * t;
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          y[j] = qg_out<A8>(acc[mt][nt][half * 2 + j], as, scale, bias, bias_kind, col + j < N ? col + j : N - 1);
        if (pairs && col < N) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(y[0], y[1]);
        } else {
          if (col < N) orow[col] = __float2bfloat16_rn(y[0]);
          if (col + 1 < N) orow[col + 1] = __float2bfloat16_rn(y[1]);
        }
      }
    }
  }
}

// the small-M tile (decode): 64 rows x QG_SMALL_BN columns
constexpr int QG_SMALL_M = 64, QG_SMALL_BN = 128;
// split k where a small-M product has fewer tiles than two waves of the
// card's 132 SMs: at most 8 splits (the last CTA's sum of the partials is a
// chain of that many L2 round trips), each at least 4 k tiles; at most
// QG_MAX_TILES tiles take part (the wrapper's counter buffer)
constexpr int QG_TARGET_CTAS = 264, QG_MAX_SPLITS = 8, QG_MIN_SPLIT_KT = 4, QG_MAX_TILES = 1024;

__host__ inline int qg_splits(int M, int N, int K) {
  if (M > QG_SMALL_M) return 1;
  const int tiles = (N + QG_SMALL_BN - 1) / QG_SMALL_BN, KT = (K + QG_BK - 1) / QG_BK;
  if (tiles >= QG_TARGET_CTAS || tiles > QG_MAX_TILES) return 1;
  int s = (QG_TARGET_CTAS + tiles - 1) / tiles;
  s = s < KT / QG_MIN_SPLIT_KT ? s : KT / QG_MIN_SPLIT_KT;
  s = s < QG_MAX_SPLITS ? s : QG_MAX_SPLITS;
  if (s <= 1) return 1;
  const int per = (KT + s - 1) / s;
  return (KT + per - 1) / per;  // no empty split
}

template <bool A8, int BM, int BN, int WM, int WN, bool SPLIT>
cudaError_t launch_quant_gemm(const void* a, const void* q, const void* ascale, const void* scale, const void* bias,
                              int bias_kind, void* out, int M, int N, int K, int splits, void* work, void* counters,
                              cudaStream_t stream) {
  constexpr int smem = QG_STAGES * qg_stage_bytes(A8, BM, BN);
  auto kernel = quant_gemm_kernel<A8, BM, BN, WM, WN, SPLIT>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int KT = (K + QG_BK - 1) / QG_BK, per = (KT + splits - 1) / splits;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(a, static_cast<const int8_t*>(q), static_cast<const float*>(ascale),
                                               static_cast<const float*>(scale), bias, bias_kind,
                                               static_cast<bf16*>(out), M, N, K, per, work,
                                               static_cast<int*>(counters));
  return cudaGetLastError();
}

template <bool A8>
cudaError_t dispatch_quant_gemm(const void* a, const void* q, const void* ascale, const void* scale, const void* bias,
                                int bias_kind, void* out, int M, int N, int K, void* work, void* counters,
                                void* stream) {
  if (M <= 0 || N <= 0) return cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = qg_splits(M, N, K);
  if (splits > 1 && (work == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  if (M <= QG_SMALL_M)
    return launch_quant_gemm<A8, QG_SMALL_M, QG_SMALL_BN, 2, 4, true>(a, q, ascale, scale, bias, bias_kind, out, M,
                                                                      N, K, splits, work, counters, st);
  return launch_quant_gemm<A8, 128, 128, 2, 4, false>(a, q, ascale, scale, bias, bias_kind, out, M, N, K, 1, nullptr,
                                                      nullptr, st);
}

}  // namespace srgpt

// k splits of an M x N x K product (1: none); a split product needs a
// workspace of splits * M * N 4-byte sums and a zeroed int32 counter per
// tile (at most 1024), which the kernel leaves zeroed
extern "C" int srgpt_quant_gemm_splits(int M, int N, int K) { return srgpt::qg_splits(M, N, K); }

// bias_kind: 0 none, 1 bf16, 2 f32 (N,)
extern "C" int srgpt_w8a8_gemm(const void* xq, const void* q, const void* ascale, const void* scale, const void* bias,
                               int bias_kind, void* out, int M, int N, int K, void* work, void* counters,
                               void* stream) {
  return static_cast<int>(
      srgpt::dispatch_quant_gemm<true>(xq, q, ascale, scale, bias, bias_kind, out, M, N, K, work, counters, stream));
}

extern "C" int srgpt_w8_gemm(const void* x, const void* q, const void* scale, const void* bias, int bias_kind,
                             void* out, int M, int N, int K, void* work, void* counters, void* stream) {
  return static_cast<int>(
      srgpt::dispatch_quant_gemm<false>(x, q, nullptr, scale, bias, bias_kind, out, M, N, K, work, counters, stream));
}

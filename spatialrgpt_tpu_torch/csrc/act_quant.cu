// K7: dynamic per-token int8 quantization of the activations of a W8A8
// projection, and K10: the same of the scaled output gradient in the int8
// backward of that projection.
//
// K7 replaces the prologue of spatialrgpt_tpu/ops/layers.py::_w8a8_dot (XLA in
// the reference, layers.py:30-35): per row of x (M, K),
//   amax = max |x|,  ascale = max(amax / 127, 1e-12),
//   xq = clip(round_half_even(x / ascale), -127, 127)  -> int8 (M, K), f32 (M,).
// K10 replaces the prologue of the SwitchBack dx in _w8a8_dot_bwd
// (layers.py:70-73): per row of dy (M, N) with the weight's f32 scale (N,),
//   dyf = f32(dy) * scale[n],  gscale = max(max |dyf| / 127, 1e-30),
//   dyq = clip(round_half_even(dyf / gscale), -127, 127)  -> int8 (M, N), f32 (M,).
//
// Bound on the H100: bytes.  K7 reads 2 bytes and writes 1 per element
// (prefill, M 20,480 x K 4096: 252 MB, 75 us at 3.35 TB/s); K10 the same
// plus the scale vector once (the align step's down projection, M 16,384 x
// N 14,336: 705 MB, 210 us).  A few operations per element.  A decode
// step's rows (64 x 4096: 0.8 MB) are bound by the launch and one round
// trip to memory, not by bytes.
//
// The arithmetic is the reference's as XLA compiles it, bit for bit (the
// optimised HLO of both shows it): the scale is the max times f32(1/127)
// (XLA folds the division by the constant into that multiply), K10's
// dy * scale one rounded multiply (__fmul_rn), x / scale an IEEE division
// (__fdiv_rn; the build has no --use_fast_math), rintf's round half to
// even, the clamp, then the cast.  The max is exact in any order, so every
// form below gives the same bits.  K % 8 == 0 and 16-byte aligned rows and
// scale (the wrappers' rule).  The int8 rows lie ld_out bytes apart (a
// multiple of 8): K10's are N rounded up to 16 (ops/int8_linear.py), the
// stride K11's tensor map needs.
//
// Where the time goes: besides the bytes, every element costs an IEEE
// division (a reciprocal on the quarter-rate MUFU pipe, a range check and
// four FMAs), rintf (quarter-rate FRND) and the clamp: at 20,480 x 4096 that
// work is most of the 75 us the bytes take, so a form is fast when its
// loads stay in flight while other warps compute, and when it keeps its
// registers few enough for the SM to hold many warps.  The cast after the
// clamp is an exact add (aq_quant), not a conversion instruction.
//
// Four forms, each reading a row once where it can; ops/int8_linear.py::
// act_quant_form picks one from the shape (scripts/bench_act_quant.py times
// them all):
// - rows (AQ_ROWS), the rule: a CTA a row of up to 2048 vectors, each
//   thread's 1-8 16-byte vectors loaded at once and held in registers
//   between the max and the quantization (K10 holds dy * scale in f32,
//   made once): one round trip to memory and one block reduction.  Few
//   rows take the most threads (the shortest chains), many rows CTAs of
//   ~128 threads (more rows in flight for the registers).  A cluster of
//   2-8 CTAs a row, its maxima met through distributed shared memory,
//   measured slower at a decode step's 32-64 rows: the cluster barriers
//   cost more than the shorter chains save.
// - ring (AQ_RING), K7 over many rows of more than 1024 vectors, and any
//   row too wide for the rows form: persistent CTAs whose row groups (1-16
//   warps a row) bring each row once into a ring of shared-memory stages
//   by a 1-D bulk copy (TMA) on an mbarrier, issued two rows ahead, and
//   read it there twice (the max, then the quantization).  A 28 KB row in
//   registers takes 80 registers a thread.
// - narrow (AQ_NARROW): rows of at most 32 vectors (K <= 256; Mixtral's
//   router dy, N 8): `lanes` (the row's vectors rounded up to a power of
//   two) lanes of a warp a row, a vector a lane, 256 / lanes rows a CTA,
//   the max over shuffles inside the lane group.
// - loop (AQ_LOOP), rows too wide for two ring stages (K10 over the
//   lm_head's 128,264 columns): one CTA of 128 threads a row and two passes
//   over it, the second from L1 / L2.
//
// K7's split form, for the fan-in slice of a tensor-parallel projection
// (wo, down), whose rows lie across the ranks, K / tp columns each: the
// reference quantizes the whole rows.  Pass 1 alone (AQ_MAX) writes each
// row's max |x| over this rank's columns; the caller reduces those maxima
// over the ranks in place (an all-reduce MAX of M floats); pass 2 alone
// (AQ_GIVEN_MAX) reads the whole row's max, writes the scale over it and
// quantizes this rank's columns.  The max is exact, so the int8 columns and
// the scales are bit-equal to K7 over the whole rows, sliced.  Each pass
// takes the form of the slice's shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srgpt {

constexpr int AQ_THREADS = 128;      // the loop form's CTA
constexpr int AQ_ROW_THREADS = 256;  // the most threads of a CTA of the rows and narrow forms
// which passes a launch runs: both, pass 1 alone, pass 2 alone (from a given max)
enum AqPass { AQ_BOTH = 0, AQ_MAX = 1, AQ_GIVEN_MAX = 2 };
enum AqForm { AQ_NARROW = 0, AQ_ROWS = 1, AQ_LOOP = 2, AQ_RING = 3 };
constexpr int AQ_RING_THREADS = 512;  // the most threads of a ring-form CTA
constexpr int AQ_RING_MAX_ROWS = 15;  // row groups of a ring-form CTA: named barriers 1-15
constexpr int AQ_SMEM_MAX = 232448;   // shared memory a CTA can have on the H100 (227 KB)

// the int8 of x / ascale, as the byte of a word: rintf and the clamp leave
// an integer r in [-127, 127], and r + 1.5 * 2^23 holds it exactly in its
// low mantissa bits (its two's complement byte), so the cast is one add
// and no conversion instruction (a quarter-rate one on this card)
__device__ __forceinline__ uint32_t aq_quant(float x, float ascale) {
  float r = rintf(__fdiv_rn(x, ascale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<uint32_t>(__float_as_int(r + 12582912.0f)) & 0xffu;
}

__device__ __forceinline__ float aq_scale(float m, bool dy) {
  return fmaxf(__fmul_rn(m, 1.0f / 127.0f), dy ? 1e-30f : 1e-12f);
}

// 8 values -> 8 int8 in one 8-byte word
__device__ __forceinline__ uint2 aq_pack8(const float (&f)[8], float s) {
  uint32_t w[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    w[half] = aq_quant(f[4 * half], s) | aq_quant(f[4 * half + 1], s) << 8 | aq_quant(f[4 * half + 2], s) << 16 |
              aq_quant(f[4 * half + 3], s) << 24;
  return make_uint2(w[0], w[1]);
}

// the 8 bf16 of a 16-byte vector, widened to f32
__device__ __forceinline__ void aq_widen(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// times the 8 columns' scales (vector c of the row), one rounded multiply each
__device__ __forceinline__ void aq_times_scale(const float4* __restrict__ col_scale, long long c, float (&f)[8]) {
  const float4 s0 = col_scale[2 * c], s1 = col_scale[2 * c + 1];
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __fmul_rn(f[i], s[i]);
}

// the 8 values of vector c of the row, widened to f32 (K10: times their
// column's scale)
template <bool DY>
__device__ __forceinline__ void aq_load8(const uint4* __restrict__ xr, const float4* __restrict__ col_scale, int c,
                                         float (&f)[8]) {
  aq_widen(xr[c], f);
  if constexpr (DY) aq_times_scale(col_scale, c, f);
}

__device__ __forceinline__ float aq_abs_max8(float m, const float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(f[i]));
  return m;
}

__device__ __forceinline__ float aq_warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// ---------------------------------------------------------------------------
// rows form: a CTA a row; thread t holds the vectors t, t + blockDim, ... (at
// most VPT) of its row
// ---------------------------------------------------------------------------
template <bool DY, int PASS, int VPT>
__global__ void __launch_bounds__(AQ_ROW_THREADS)
    act_quant_rows_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ col_scale,
                          int8_t* __restrict__ xq, float* __restrict__ ascale, int K, long long ld_out) {
  __shared__ float warp_max[AQ_ROW_THREADS / 32];
  const long long row = blockIdx.x;
  const int vecs = K / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * K);
  const float4* cs = reinterpret_cast<const float4*>(col_scale);

  // the thread's vectors, all in flight before the first is used
  uint4 v[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    v[i] = c < vecs ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
  }
  // K10: dy * scale, made once (a zero vector past the row's end stays zero)
  float f[DY ? VPT : 1][8];
  if constexpr (DY) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      aq_widen(v[i], f[i]);
      const int c = threadIdx.x + i * blockDim.x;
      if (c < vecs) aq_times_scale(cs, c, f[i]);
    }
  }

  float m = 0.0f;
  if constexpr (PASS == AQ_GIVEN_MAX) {
    m = ascale[row];
    __syncthreads();  // every thread holds the max before thread 0 writes the scale over it
  } else {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if constexpr (DY) {
        m = aq_abs_max8(m, f[i]);
      } else {
        float g[8];
        aq_widen(v[i], g);
        m = aq_abs_max8(m, g);
      }
    }
    m = aq_warp_max(m);
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    m = warp_max[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmaxf(m, warp_max[w]);
    if constexpr (PASS == AQ_MAX) {
      if (threadIdx.x == 0) ascale[row] = m;
      return;
    }
  }
  const float s = aq_scale(m, DY);
  if (threadIdx.x == 0) ascale[row] = s;

  uint2* qr = reinterpret_cast<uint2*>(xq + row * ld_out);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < vecs) {
      if constexpr (DY) {
        qr[c] = aq_pack8(f[i], s);
      } else {
        float g[8];
        aq_widen(v[i], g);
        qr[c] = aq_pack8(g, s);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// narrow form: `lanes` (a power of two, 1-32, >= the row's vectors) lanes a
// row, blockDim / lanes rows a CTA
// ---------------------------------------------------------------------------
template <bool DY, int PASS>
__global__ void __launch_bounds__(AQ_ROW_THREADS)
    act_quant_narrow_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ col_scale,
                            int8_t* __restrict__ xq, float* __restrict__ ascale, long long M, int K,
                            long long ld_out, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / lanes) + threadIdx.x / lanes;
  const bool live_row = row < M, live = live_row && lane < K / 8;
  float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) aq_load8<DY>(reinterpret_cast<const uint4*>(x + row * K), reinterpret_cast<const float4*>(col_scale),
                         lane, f);
  float m = 0.0f;
  if constexpr (PASS == AQ_GIVEN_MAX) {
    if (live_row) m = ascale[row];
    __syncwarp();  // the row's lanes (one warp) hold the max before its first lane writes the scale over it
  } else {
    m = aq_abs_max8(m, f);
    for (int o = lanes >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if constexpr (PASS == AQ_MAX) {
      if (live_row && lane == 0) ascale[row] = m;
      return;
    }
  }
  const float s = aq_scale(m, DY);
  if (live_row && lane == 0) ascale[row] = s;
  if (live) reinterpret_cast<uint2*>(xq + row * ld_out)[lane] = aq_pack8(f, s);
}

// ---------------------------------------------------------------------------
// ring form: persistent CTAs of `groups` row groups of `warps` warps each;
// group g of CTA b takes rows b * groups + g, then every gridDim * groups
// rows further.  Each group brings its rows into a ring of `stages` shared-
// memory stages, one 1-D bulk copy (TMA) a row on the stage's mbarrier,
// issued `stages` rows ahead by its first thread; the group reads a stage
// twice (the max, then the quantization) and frees it at a group barrier.
// Shared memory: groups * stages rows (each rounded up to 128 bytes), then
// groups * stages mbarriers, then 16 floats a group (its warps' maxima).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t aq_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one row of `bytes` from global memory into shared memory, counted on the mbarrier `bar`
__device__ __forceinline__ void aq_bulk_row(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void aq_bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the threads of row group g (one warp: __syncwarp; more: named barrier 1 + g)
__device__ __forceinline__ void aq_group_sync(int g, int threads) {
  if (threads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(threads) : "memory");
}

__host__ __device__ inline uint32_t aq_ring_stride(int K) { return (static_cast<uint32_t>(K) * 2u + 127u) & ~127u; }

__host__ __device__ inline size_t aq_ring_smem(int K, int groups, int stages) {
  return static_cast<size_t>(groups) * stages * (aq_ring_stride(K) + 8) + static_cast<size_t>(groups) * 16 * 4;
}

template <bool DY, int PASS>
__global__ void __launch_bounds__(AQ_RING_THREADS)
    act_quant_ring_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ col_scale,
                          int8_t* __restrict__ xq, float* __restrict__ ascale, long long M, int K, long long ld_out,
                          int warps, int stages) {
  extern __shared__ __align__(128) uint8_t aq_smem[];
  const int lane = threadIdx.x & 31, groups = blockDim.x / (32 * warps), gthreads = 32 * warps;
  const int g = threadIdx.x / gthreads, gt = threadIdx.x % gthreads;
  const uint32_t row_bytes = static_cast<uint32_t>(K) * 2u, stride = aq_ring_stride(K);
  uint8_t* ring = aq_smem + static_cast<size_t>(g) * stages * stride;
  uint64_t* bars = reinterpret_cast<uint64_t*>(aq_smem + static_cast<size_t>(groups) * stages * stride) + g * stages;
  float* warp_max = reinterpret_cast<float*>(reinterpret_cast<uint64_t*>(aq_smem + static_cast<size_t>(groups) *
                                                                                         stages * stride) +
                                             groups * stages) +
                    g * 16;
  const float4* cs = reinterpret_cast<const float4*>(col_scale);
  const long long first = static_cast<long long>(blockIdx.x) * groups + g;
  const long long step = static_cast<long long>(gridDim.x) * groups;
  if (gt == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(aq_smem_u32(bars + s)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < stages; ++s) {
      const long long row = first + s * step;
      if (row < M) aq_bulk_row(aq_smem_u32(ring + s * stride), x + row * K, row_bytes, aq_smem_u32(bars + s));
    }
  }
  aq_group_sync(g, gthreads);
  const int vecs = K / 8;
  int it = 0;
  for (long long row = first; row < M; row += step, ++it) {
    const int s = it % stages;
    aq_bar_wait(aq_smem_u32(bars + s), (it / stages) & 1);
    const uint4* buf = reinterpret_cast<const uint4*>(ring + s * stride);
    float m = 0.0f;
    if constexpr (PASS == AQ_GIVEN_MAX) {
      m = ascale[row];
    } else {
      for (int c = gt; c < vecs; c += gthreads) {
        float f[8];
        aq_load8<DY>(buf, cs, c, f);
        m = aq_abs_max8(m, f);
      }
      m = aq_warp_max(m);
      if (warps > 1) {
        if (lane == 0) warp_max[gt >> 5] = m;
        aq_group_sync(g, gthreads);
        m = warp_max[0];
        for (int w = 1; w < warps; ++w) m = fmaxf(m, warp_max[w]);
      }
    }
    const float sc = aq_scale(m, DY);
    if constexpr (PASS != AQ_MAX) {
      uint2* qr = reinterpret_cast<uint2*>(xq + row * ld_out);
      for (int c = gt; c < vecs; c += gthreads) {
        float f[8];
        aq_load8<DY>(buf, cs, c, f);
        qr[c] = aq_pack8(f, sc);
      }
    }
    // the stage (and warp_max, and a given max) is read by every thread of
    // the group: write the row's max or scale, and refill the stage
    aq_group_sync(g, gthreads);
    if (gt == 0) {
      ascale[row] = PASS == AQ_MAX ? m : sc;
      const long long next = row + static_cast<long long>(stages) * step;
      if (next < M) aq_bulk_row(aq_smem_u32(ring + s * stride), x + next * K, row_bytes, aq_smem_u32(bars + s));
    }
  }
}

// ---------------------------------------------------------------------------
// loop form: one CTA of AQ_THREADS a row, two passes over it
// ---------------------------------------------------------------------------
template <bool DY, int PASS>
__global__ void __launch_bounds__(AQ_THREADS) act_quant_loop_kernel(const __nv_bfloat16* __restrict__ x,
                                                                     const float* __restrict__ col_scale,
                                                                     int8_t* __restrict__ xq,
                                                                     float* __restrict__ ascale, int K,
                                                                     long long ld_out) {
  __shared__ float warp_max[AQ_THREADS / 32];
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * K);
  const float4* cs = reinterpret_cast<const float4*>(col_scale);
  const int vecs = K / 8;

  float m = 0.0f;
  if constexpr (PASS == AQ_GIVEN_MAX) {
    m = ascale[row];
    __syncthreads();  // every thread holds the max before thread 0 writes the scale over it
  } else {
    for (int c = threadIdx.x; c < vecs; c += AQ_THREADS) {
      float f[8];
      aq_load8<DY>(xr, cs, c, f);
      m = aq_abs_max8(m, f);
    }
    m = aq_warp_max(m);
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    m = warp_max[0];
#pragma unroll
    for (int w = 1; w < AQ_THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    if constexpr (PASS == AQ_MAX) {
      if (threadIdx.x == 0) ascale[row] = m;
      return;
    }
  }
  const float s = aq_scale(m, DY);
  if (threadIdx.x == 0) ascale[row] = s;

  uint2* qr = reinterpret_cast<uint2*>(xq + row * ld_out);
  for (int c = threadIdx.x; c < vecs; c += AQ_THREADS) {
    float f[8];
    aq_load8<DY>(xr, cs, c, f);
    qr[c] = aq_pack8(f, s);
  }
}

__global__ void empty_kernel() {}

struct AqArgs {
  const __nv_bfloat16* x;
  const float* col_scale;
  int8_t* xq;
  float* ascale;
  long long M;
  int K;
  long long ld_out;
  int warps, count, each;  // the form's launch numbers (srgpt_act_quant)
  cudaStream_t stream;
};

template <bool DY, int PASS, int VPT>
cudaError_t aq_rows_launch(const AqArgs& a) {
  act_quant_rows_kernel<DY, PASS, VPT><<<static_cast<unsigned>(a.M), a.count, 0, a.stream>>>(
      a.x, a.col_scale, a.xq, a.ascale, a.K, a.ld_out);
  return cudaGetLastError();
}

// the ring form's launch: `warps` warps a row group, `count` row groups a
// CTA (named barriers 1-15), `each` stages; as many CTAs as fit on every SM
// at once (no more than the rows need)
template <bool DY, int PASS>
cudaError_t aq_ring_launch(const AqArgs& a) {
  auto kern = act_quant_ring_kernel<DY, PASS>;
  const int threads = 32 * a.warps * a.count;
  const size_t smem = aq_ring_smem(a.K, a.count, a.each);
  // per instantiation: the shared memory allowed so far, the SM count, and
  // the occupancy of the last (threads, smem) (set and read outside a
  // graph's capture: the first call of a shape comes before it)
  static int smem_set = 48 * 1024, sms = 0, occ_threads = 0, occ = 0;
  static size_t occ_smem = 0;
  cudaError_t err;
  if (static_cast<int>(smem) > smem_set) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = static_cast<int>(smem);
  }
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (occ_threads != threads || occ_smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, smem);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    occ_threads = threads;
    occ_smem = smem;
  }
  const long long ctas = (a.M + a.count - 1) / a.count;
  const long long grid = ctas < static_cast<long long>(occ) * sms ? ctas : static_cast<long long>(occ) * sms;
  kern<<<static_cast<unsigned>(grid), threads, smem, a.stream>>>(a.x, a.col_scale, a.xq, a.ascale, a.M, a.K, a.ld_out,
                                                                 a.warps, a.each);
  return cudaGetLastError();
}

template <bool DY, int PASS>
cudaError_t aq_launch(int form, const AqArgs& a) {
  if (form == AQ_RING) return aq_ring_launch<DY, PASS>(a);
  if (form == AQ_NARROW) {
    const long long rows_per_cta = a.count / a.each;
    const long long grid = (a.M + rows_per_cta - 1) / rows_per_cta;
    act_quant_narrow_kernel<DY, PASS><<<static_cast<unsigned>(grid), a.count, 0, a.stream>>>(
        a.x, a.col_scale, a.xq, a.ascale, a.M, a.K, a.ld_out, a.each);
    return cudaGetLastError();
  }
  if (form == AQ_LOOP) {
    act_quant_loop_kernel<DY, PASS><<<static_cast<unsigned>(a.M), AQ_THREADS, 0, a.stream>>>(
        a.x, a.col_scale, a.xq, a.ascale, a.K, a.ld_out);
    return cudaGetLastError();
  }
  switch (a.each) {
    case 1: return aq_rows_launch<DY, PASS, 1>(a);
    case 2: return aq_rows_launch<DY, PASS, 2>(a);
    case 4: return aq_rows_launch<DY, PASS, 4>(a);
    case 8: return aq_rows_launch<DY, PASS, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace srgpt

// K7 (col_scale null) or K10 (col_scale the weight's f32 scale (K,)): x (M, K)
// bf16 -> xq (M, K) int8 with rows ld_out bytes apart (ld_out >= K, a multiple
// of 8) and ascale (M,) f32.  pass: 0 both passes; K7 alone also 1, the rows'
// max |x| into ascale (xq unused), and 2, from the rows' maxima in ascale,
// overwritten by the scales.  form, warps, count, each:
// ops/int8_linear.py::act_quant_form's: the rows form's threads a CTA
// (count) and vectors a thread (each); the narrow form's threads a CTA
// (count) and lanes a row (each); the ring form's warps a row group
// (warps), row groups a CTA (count) and stages (each); the loop form reads
// none.
extern "C" int srgpt_act_quant(const void* x, const void* col_scale, void* xq, void* ascale, long long M, int K,
                               long long ld_out, int pass, int form, int warps, int count, int each, void* stream) {
  using namespace srgpt;
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  const int vecs = K / 8;
  const bool dy = col_scale != nullptr;
  bool ok = K > 0 && K % 8 == 0 && pass >= AQ_BOTH && pass <= AQ_GIVEN_MAX && !(dy && pass != AQ_BOTH) &&
            (pass == AQ_MAX || (ld_out >= K && ld_out % 8 == 0)) && M < (1LL << 31);
  if (form == AQ_NARROW)
    ok = ok && each >= vecs && each <= 32 && (each & (each - 1)) == 0 && count >= 32 && count <= AQ_ROW_THREADS &&
         count % 32 == 0;
  else if (form == AQ_ROWS)
    ok = ok && count >= 32 && count <= AQ_ROW_THREADS && count % 32 == 0 && static_cast<long long>(count) * each >= vecs;
  else if (form == AQ_RING)
    ok = ok && warps >= 1 && count >= 1 && count <= AQ_RING_MAX_ROWS && 32 * warps * count <= AQ_RING_THREADS &&
         each >= 1 && aq_ring_smem(K, count, each) <= AQ_SMEM_MAX && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  else
    ok = ok && form == AQ_LOOP;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const AqArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(col_scale), static_cast<int8_t*>(xq),
                 static_cast<float*>(ascale), M, K, ld_out, warps, count, each, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dy)
    err = aq_launch<true, AQ_BOTH>(form, a);
  else if (pass == AQ_MAX)
    err = aq_launch<false, AQ_MAX>(form, a);
  else if (pass == AQ_GIVEN_MAX)
    err = aq_launch<false, AQ_GIVEN_MAX>(form, a);
  else
    err = aq_launch<false, AQ_BOTH>(form, a);
  return static_cast<int>(err);
}

// an empty kernel, for the floor of a launch in a CUDA graph beside K7's decode rows
extern "C" int srgpt_empty_kernel(void* stream) {
  srgpt::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

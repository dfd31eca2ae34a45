// K2: causal x packed-segment (x sliding-window) prefill attention, GQA.
//
// Replaces the Pallas kernel
// spatialrgpt_tpu/ops/prefill_attention.py::onepass_attention (_onepass / _kernel).
//
// Bound on the H100: device-memory bytes.  At the llama3-8b prefill shape
// (B = 8, S = 320, Hq = 32, Hk = 8, D = 128, right-padded rows) a call does
// ~5.7 GFLOP of live causal products (6 us at 989 TFLOP/s) and moves ~50 MB
// of q/k/v/out (15 us at 3.35 TB/s).  With 2.5 key tiles per row the work
// per CTA is small, so what counts is how few bytes each CTA loads and how
// soon its products start.
//
// Design at D <= 128: the Hopper main loop of attention_sm90.cuh at a
// head-dim width of 128, mode PREFILL.  One CTA per (q tile, kv head,
// batch) serves the G = Hq / Hk query heads that share the kv head (the
// Pallas kernel's fold_g): one 4-D TMA box {64, G, 128 / G, 1} of q puts G
// heads x 128 / G positions in the 128 rows of the Q tile, so K and V are
// read once per kv head (at llama3-8b's G = 4, 32 positions per CTA and a
// grid of 10 x 8 x 8).  The mask is built in the kernel from the (B, S)
// segment ids, which the producer's warp copies into each K/V stage: key j
// is live for query i iff seg[j] == seg[i] != 0, j <= i and (window <= 0 or
// i - j < window).  Key tiles outside the CTA's live queries' [first -
// window + 1, last] are never loaded; tiles in which no row of a thread
// meets the diagonal, the window or a segment edge are maskless.  Keys >= S
// are TMA's zero fill with segment id 0.  Rows of segment 0 store zeros.
// q/k/v/out go through the caller's (B, S, H, D) strides; any S, D % 8 == 0
// (TMA zero-fills the head dim to 128).
//
// Design at 128 < D <= 256 (Gemma-7B: B8 S320 Hq16 Hk16 D256, G = 1):
// prefill_d256_sm90_kernel below, the same fold, mask, tile range,
// producer / consumer split and online softmax on the same PTX pieces, at
// shapes that fit a CTA.  Q is 128 rows x 256 columns, four 128B-swizzled
// atoms: 64 KB.  Key tiles are 64 keys (dQ's tiles of attention_sm90.cuh):
// K and V 32 KB each, two stages 128 KB, so 198 KB of shared memory in all
// (128-key tiles would need 256 KB for the ring alone).  Per tile a
// consumer warpgroup computes S = Q K^T as 16 wgmma m64n64k16 from shared
// memory (32 f32 a thread) and O += P V as 4 k-steps x two wgmma
// m64n128k16 (the two 128-column halves of V, each two atoms read MN-major),
// P from registers; O is 64 x 256 f32, 128 registers a consumer thread
// (setmaxnreg 232).

#include "attention_sm90.cuh"

namespace srgpt {
namespace sm90 {

constexpr int D256 = 256;                          // the second form's DMAX
constexpr int D256_BN = 64;                        // keys per tile
constexpr int D256_ATOMS = D256 / ATOM;            // swizzle atoms across a row: 4
constexpr int D256_Q_BYTES = D256_ATOMS * ATOM_BYTES;   // 128 rows: 64 KB
constexpr int D256_KV_ATOM = D256_BN * 128;             // 64 rows of one atom: 8 KB
constexpr int D256_KV_BYTES = D256_ATOMS * D256_KV_ATOM;  // a 64-key tile: 32 KB
constexpr int D256_OFF_K = D256_Q_BYTES;                               // + stage * D256_KV_BYTES
constexpr int D256_OFF_V = D256_OFF_K + NSTAGES * D256_KV_BYTES;       // + stage * D256_KV_BYTES
constexpr int D256_OFF_SEG = D256_OFF_V + NSTAGES * D256_KV_BYTES;     // + stage * D256_BN * 4
constexpr int D256_OFF_BARS = D256_OFF_SEG + NSTAGES * D256_BN * 4;
// barriers (q_full, full[2], empty[2]), the live-query range, alignment
constexpr int D256_SMEM_BYTES = D256_OFF_BARS + 64 + 1024;
static_assert(D256_SMEM_BYTES <= 227 * 1024, "K2's D = 256 form must fit one CTA's shared memory");

__global__ void __launch_bounds__(NTHREADS, 1)
prefill_d256_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + D256_OFF_BARS;
  const uint32_t bar_full = bar_q + 8;    // + 8 * stage
  const uint32_t bar_empty = bar_q + 24;  // + 8 * stage
  int* live_range = reinterpret_cast<int*>(smem + D256_OFF_BARS + 40);

  const int b = blockIdx.z, h = blockIdx.y;  // h: the kv head
  const int BQ = BM / p.G;
  const int q0 = blockIdx.x * BQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(bar_full + 8 * s, 2);  // the TMA bytes and the segment ids
      mbar_init(bar_empty + 8 * s, NCONSUMER);
    }
    live_range[0] = INT_MAX;
    live_range[1] = -1;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
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
  const int t_begin = p.window > 0 && last >= 0 ? max(first - p.window + 1, 0) / D256_BN : 0;
  const int n_tiles = last < 0 ? 0 : last / D256_BN + 1 - t_begin;

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    // lane 0 issues the TMA loads; the warp copies each key tile's segment
    // ids into its stage (2 a lane), and lane 0 arrives once more for them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(bar_q, D256_Q_BYTES);
        for (int a = 0; a < D256_ATOMS; ++a)
          tma_load_4d(base + a * ATOM_BYTES, &tm_q, bar_q, a * ATOM, h * p.G, q0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % NSTAGES;
        const int j0 = (t_begin + n) * D256_BN;
        mbar_wait(bar_empty + 8 * st, ((n / NSTAGES) & 1) ^ 1);  // the first round passes at once
        if (lane == 0) {
          mbar_expect_tx(bar_full + 8 * st, 2 * D256_KV_BYTES);
          for (int a = 0; a < D256_ATOMS; ++a) {
            tma_load_4d(base + D256_OFF_K + st * D256_KV_BYTES + a * D256_KV_ATOM, &tm_k, bar_full + 8 * st,
                        a * ATOM, h, j0, b);
            tma_load_4d(base + D256_OFF_V + st * D256_KV_BYTES + a * D256_KV_ATOM, &tm_v, bar_full + 8 * st,
                        a * ATOM, h, j0, b);
          }
        }
        int ids[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + 2 * lane + u;
          ids[u] = j < p.S ? p.seg[static_cast<long long>(b) * p.S + j] : 0;
        }
        *reinterpret_cast<int2*>(smem + D256_OFF_SEG + st * D256_BN * 4 + 8 * lane) = make_int2(ids[0], ids[1]);
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

    // position and segment of this thread's two rows; -1 for a row of
    // segment 0 or past S (it needs no key and stores zeros)
    int pos[2], sid[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = q0 + (r_lo + 8 * hr) / p.G;
      sid[hr] = i < p.S ? p.seg[static_cast<long long>(b) * p.S + i] : 0;
      pos[hr] = sid[hr] != 0 ? i : -1;
    }

    float o[2][64];  // the two 128-column halves of this thread's O
#pragma unroll
    for (int i = 0; i < 64; ++i) o[0][i] = o[1][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

    mbar_wait(bar_q, 0);
    const uint32_t q_tile = base + cw * 64 * 128;  // 64 rows x 128 bytes into each atom

    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % NSTAGES;
      const int j0 = (t_begin + n) * D256_BN;
      mbar_wait(bar_full + 8 * st, (n / NSTAGES) & 1);
      const uint32_t k_tile = base + D256_OFF_K + st * D256_KV_BYTES;
      const uint32_t v_tile = base + D256_OFF_V + st * D256_KV_BYTES;

      // ---- S = Q K^T: 16 k-steps of 16 columns (4 per atom) ----
      float s[D256_BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D256 / 16; ++kk) {
        const uint32_t oq = (kk / 4) * ATOM_BYTES + (kk % 4) * 32, ok = (kk / 4) * D256_KV_ATOM + (kk % 4) * 32;
        wgmma_m64n64k16_ss(s, sw128_desc(q_tile + oq, 1, 64), sw128_desc(k_tile + ok, 1, 64), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // ---- scores in the exp2 domain; the mask where a row meets the
      // diagonal, the window edge or another segment in this tile ----
#pragma unroll
      for (int i = 0; i < D256_BN / 2; ++i) s[i] *= p.scale_log2;
      const int* kseg = reinterpret_cast<const int*>(smem + D256_OFF_SEG + st * D256_BN * 4);
      const int2 ids = *reinterpret_cast<const int2*>(kseg + 2 * lane);
      const int kmin = __reduce_min_sync(0xffffffffu, min(ids.x, ids.y));
      const int kmax = __reduce_max_sync(0xffffffffu, max(ids.x, ids.y));
      bool interior = true;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (pos[hr] >= 0)
          interior = interior && kmin == sid[hr] && kmax == sid[hr] && j0 + D256_BN - 1 <= pos[hr] &&
                     (p.window <= 0 || pos[hr] - j0 < p.window);
      if (!interior) {
#pragma unroll
        for (int i = 0; i < D256_BN / 2; ++i) {
          const int hr = (i >> 1) & 1, c = 8 * (i / 4) + cq + (i & 1), j = j0 + c;
          const bool live = kseg[c] == sid[hr] && j <= pos[hr] && (p.window <= 0 || pos[hr] - j < p.window);
          if (!live) s[i] = -INFINITY;
        }
      }

      // ---- online softmax: rows r_lo (hr = 0) and r_lo + 8 (hr = 1) ----
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < D256_BN / 2; ++i)
          if (((i >> 1) & 1) == hr) mx = fmaxf(mx, s[i]);
        const float m_new = fmaxf(m_run[hr], quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no live key yet
        alpha[hr] = exp2f(m_run[hr] - m_use);
        m_run[hr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < D256_BN / 2; ++i)
          if (((i >> 1) & 1) == hr) {
            s[i] = exp2f(s[i] - m_use);
            sum += s[i];
          }
        l_run[hr] = l_run[hr] * alpha[hr] + sum;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        o[0][i] *= alpha[(i >> 1) & 1];
        o[1][i] *= alpha[(i >> 1) & 1];
      }

      // ---- O += P V: 4 k-steps of 16 keys, each over V's two 128-column
      // halves (two atoms of 64 keys each, read MN-major), P from registers ----
      uint32_t pa[D256_BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < D256_BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) pa[kk][c] = pack_bf16(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D256_BN / 16; ++kk) {
        // 8-key groups 1024 bytes apart (SBO), a half's two atoms D256_KV_ATOM apart (LBO)
        wgmma_m64n128k16_rs(o[0], pa[kk], sw128_desc(v_tile + kk * 16 * 128, D256_KV_ATOM / 16, 64));
        wgmma_m64n128k16_rs(o[1], pa[kk],
                            sw128_desc(v_tile + 2 * D256_KV_ATOM + kk * 16 * 128, D256_KV_ATOM / 16, 64));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o[0]);
      fence_regs(o[1]);
      mbar_arrive(bar_empty + 8 * st);
    }

    // ---- epilogue: O / l through the caller's strides ----
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float l = quad_sum(l_run[hr]);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int r = r_lo + 8 * hr;
      const int row = q0 + r / p.G, head = h * p.G + r % p.G;
      if (row < p.S) {
        bf16* dst = p.out + b * p.sob + row * p.sos + head * p.soh;
        const bool dead = pos[hr] < 0;  // a row of segment 0 stores zeros
#pragma unroll
        for (int j = 0; j < D256 / 8; ++j) {
          const int col = 8 * j + cq, half = j / 16, jj = j % 16;
          if (col < p.D)
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                dead ? __floats2bfloat162_rn(0.f, 0.f)
                     : __floats2bfloat162_rn(o[half][4 * jj + 2 * hr] * inv, o[half][4 * jj + 2 * hr + 1] * inv);
        }
      }
    }
  }
}

}  // namespace sm90
}  // namespace srgpt

extern "C" int srgpt_prefill_attention(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    int B, int S, int Hq, int Hk, int D,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    int window, float sm_scale, void* stream) {
  using namespace srgpt::sm90;
  if (B <= 0 || S <= 0 || Hk <= 0 || Hq % Hk != 0 || BM % (Hq / Hk) != 0 || D <= 0 || D % 8 != 0 || D > D256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hk;
  Params p{};
  p.out = static_cast<bf16*>(out);
  p.sob = sob;
  p.sos = sos;
  p.soh = soh;
  p.S = S;
  p.H = Hq;
  p.D = D;
  p.kv_len = S;
  p.scale_log2 = sm_scale * LOG2E;
  p.seg = static_cast<const int*>(seg);
  p.G = G;
  p.window = window;
  const bool wide = D > WIDE;  // the D = 256 form: 64-key tiles
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, S, Hq, D, sqb, sqs, sqh, G, BM / G);
  if (err == cudaSuccess) err = make_map(&tk, k, B, S, Hk, D, skb, sks, skh, 1, wide ? D256_BN : BM);
  if (err == cudaSuccess) err = make_map(&tv, v, B, S, Hk, D, svb, svs, svh, 1, wide ? D256_BN : BM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BM / G - 1) / (BM / G), Hk, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!wide) return static_cast<int>(launch_kernel<WIDE, PREFILL>(tq, tk, tv, p, grid, st));
  err = cudaFuncSetAttribute(prefill_d256_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D256_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefill_d256_sm90_kernel<<<grid, NTHREADS, D256_SMEM_BYTES, st>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

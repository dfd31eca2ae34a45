// Hopper (sm_90a) attention at head dims 128 < D <= 256 (Gemma-7B's 256):
// K2's prefill form and K4's forward (d256_fwd_sm90_kernel, one template,
// modes PREFILL and FLASH_FWD), K4's dQ (flash_dq_d256_sm90_kernel) and
// K4's dK/dV (flash_dkv_d256_sm90_kernel).  The pieces (TMA boxes, 128B
// swizzle atoms, wgmma wrappers, mbarrier ring, list_live_tiles, the mask
// and the interior-tile test) are attention_sm90.cuh's; only the tile
// shapes change, so that a row of 256 columns fits one CTA's 227 KB:
//
//   forward: 128 query rows (Q 64 KB: four 128-row atoms), 64-key K/V tiles
//     (32 KB each) in 2 stages, 198 KB (+3 KB of tile list for K4).  S = Q
//     K^T is 16 wgmma m64n64k16 from shared memory; O += P V is 4 k-steps x
//     two m64n128k16 (V's two 128-column halves, read MN-major), P from
//     registers; O is 64 x 256 f32, 128 registers a consumer thread.
//   dQ: the forward's 128 query rows (its fold) with Q and dO resident (64
//     KB each); K and V stream as 32-key halves of the listed 64-key tiles
//     (16 KB each, 2 stages).  S and dP are 64 x 32 (16 wgmma m64n32k16
//     each), dQ += dS K is 2 k-steps x two m64n128k16; dQ 64 x 256 f32 in
//     registers.  201 KB.
//   dK/dV: 64 keys of one kv head a CTA (K and V 32 KB each, resident); the
//     listed 64-query tiles x the G heads stream through 2 stages of Q and
//     dO (32 KB each).  Consumer warpgroup 1 owns dV and warpgroup 2 dK, 64
//     x 256 f32 each (128 registers a thread): both compute S^T = K Q^T,
//     warpgroup 2 also dP^T = V dO^T; dV += bf16(P^T) dO and dK +=
//     bf16(dS^T) Q as 4 k-steps x two m64n128k16.  199 KB.

#pragma once

#include "attention_sm90.cuh"

namespace srgpt {
namespace sm90 {

constexpr int D256 = 256;                                  // the head-dim width of these forms
constexpr int D256_BN = 64;                                // keys per forward tile
constexpr int D256_ATOMS = D256 / ATOM;                    // swizzle atoms across a row: 4
constexpr int D256_Q_BYTES = D256_ATOMS * ATOM_BYTES;      // 128 rows: 64 KB
constexpr int D256_KV_ATOM = D256_BN * 128;                // 64 rows of one atom: 8 KB
constexpr int D256_KV_BYTES = D256_ATOMS * D256_KV_ATOM;   // a 64-row tile: 32 KB
constexpr int D256_OFF_K = D256_Q_BYTES;                            // + stage * D256_KV_BYTES
constexpr int D256_OFF_V = D256_OFF_K + NSTAGES * D256_KV_BYTES;    // + stage * D256_KV_BYTES
constexpr int D256_OFF_SEG = D256_OFF_V + NSTAGES * D256_KV_BYTES;  // + stage * D256_BN * 4
constexpr int D256_OFF_LIST = D256_OFF_SEG + NSTAGES * D256_BN * 4;  // K4: the tile list
__host__ __device__ constexpr int d256_off_bars(int mode) {
  return D256_OFF_LIST + (mode == FLASH_FWD ? TILE_LIST_BYTES : 0);
}
// barriers (q_full, full[2], empty[2]), the live-query range (K4:
// list_live_tiles' 5 ints), alignment
__host__ __device__ constexpr int d256_smem_bytes(int mode) { return d256_off_bars(mode) + 64 + 1024; }
static_assert(d256_smem_bytes(FLASH_FWD) <= 227 * 1024, "the D = 256 forward must fit one CTA's shared memory");

// D (64 x 32, f32, registers) (+)= A (64 x 16, shared, K-major) * B (16 x 32, shared, K-major)
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// forward: K2 (PREFILL) and K4 (FLASH_FWD: the listed live tiles, the LSE)
// ---------------------------------------------------------------------------

template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 1)
d256_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  static_assert(MODE == PREFILL || MODE == FLASH_FWD, "the D = 256 forward serves K2 and K4");
  constexpr bool LISTED = MODE == FLASH_FWD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + d256_off_bars(MODE);
  const uint32_t bar_full = bar_q + 8;    // + 8 * stage
  const uint32_t bar_empty = bar_q + 24;  // + 8 * stage
  // K2: first, last live query; K4: list_live_tiles' scratch
  int* live_range = reinterpret_cast<int*>(smem + d256_off_bars(MODE) + 40);
  unsigned char* tile_flags = smem + D256_OFF_LIST;  // K4
  short* tile_list = reinterpret_cast<short*>(tile_flags + MAX_TILES);

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
    if constexpr (LISTED) {
      live_range[2] = INT_MAX;
      live_range[3] = INT_MIN;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the Q tile loads while the CTA finds its key tiles
    mbar_expect_tx(bar_q, D256_Q_BYTES);
    for (int a = 0; a < D256_ATOMS; ++a) tma_load_4d(base + a * ATOM_BYTES, &tm_q, bar_q, a * ATOM, h * p.G, q0, b);
  }
  int t_begin = 0, n_tiles;
  if constexpr (LISTED) {
    n_tiles = list_live_tiles<D256_BN>(p.seg + static_cast<long long>(b) * p.S, p.S, p.window, q0, BQ, live_range,
                                       tile_flags, tile_list);
  } else {
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
    t_begin = p.window > 0 && last >= 0 ? max(first - p.window + 1, 0) / D256_BN : 0;
    n_tiles = last < 0 ? 0 : last / D256_BN + 1 - t_begin;
  }

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    // lane 0 issues the TMA loads; the warp copies each key tile's segment
    // ids into its stage (2 a lane), and lane 0 arrives once more for them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lane = threadIdx.x;
    if (lane < 32) {
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % NSTAGES;
        const int j0 = (LISTED ? tile_list[n] : t_begin + n) * D256_BN;
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
      const int j0 = (LISTED ? tile_list[n] : t_begin + n) * D256_BN;
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

    // ---- epilogue: O / l through the caller's strides (K4: and the LSE) ----
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float l = quad_sum(l_run[hr]);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int r = r_lo + 8 * hr;
      const int row = q0 + r / p.G, head = h * p.G + r % p.G;
      const bool dead = pos[hr] < 0;  // a row of segment 0 stores zeros
      if constexpr (LISTED) {
        // the quad's rows share m and l: its first thread stores the LSE
        if (row < p.S && cq == 0)
          p.lse[(static_cast<long long>(b) * p.H + head) * p.S + row] =
              dead || l <= 0.f ? NEG_INF : (m_run[hr] + log2f(l)) * LN2;
      }
      if (row < p.S) {
        bf16* dst = p.out + b * p.sob + row * p.sos + head * p.soh;
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

// ---------------------------------------------------------------------------
// K4's dQ at D = 256: the forward's fold, 32-key halves of the listed tiles
// ---------------------------------------------------------------------------
//
// Per half tile, each consumer warpgroup (64 rows): S = Q K^T and dP = dO
// V^T as 2 x 16 wgmma m64n32k16 from shared memory, one commit; P =
// exp2(S scale log2(e) - lse log2(e)) on the live pairs (not rounded, as
// _bwd_dq_kernel), dS = P (dP - delta) scale rounded to bf16 in registers;
// dQ += dS K as 2 k-steps x two m64n128k16, K read MN-major.  Rows of
// segment 0 store zeros (lse +inf in log2 units, so P is 0), rows >= S
// nothing.  No atomics: deterministic.

constexpr int DQ256_BN = 32;                                    // keys per stage: half a listed tile
constexpr int DQ256_KV_ATOM = DQ256_BN * 128;                   // 32 rows of one atom: 4 KB
constexpr int DQ256_KV_BYTES = D256_ATOMS * DQ256_KV_ATOM;      // a 32-key stage of K or V: 16 KB
constexpr int DQ256_OFF_DO = D256_Q_BYTES;
constexpr int DQ256_OFF_K = 2 * D256_Q_BYTES;                          // + stage * DQ256_KV_BYTES
constexpr int DQ256_OFF_V = DQ256_OFF_K + NSTAGES * DQ256_KV_BYTES;    // + stage * DQ256_KV_BYTES
constexpr int DQ256_OFF_SEG = DQ256_OFF_V + NSTAGES * DQ256_KV_BYTES;  // + stage * DQ256_BN * 4
constexpr int DQ256_OFF_LIST = DQ256_OFF_SEG + NSTAGES * DQ256_BN * 4;
constexpr int DQ256_OFF_BARS = DQ256_OFF_LIST + TILE_LIST_BYTES;
// barriers (q_full, full[2], empty[2]), list_live_tiles' 5 ints, alignment
constexpr int DQ256_SMEM_BYTES = DQ256_OFF_BARS + 64 + 1024;
static_assert(DQ256_SMEM_BYTES <= 227 * 1024, "the D = 256 dQ must fit one CTA's shared memory");

template <int DMAX>  // 256: instantiated only where it is launched (flash_attention_sm90.cu)
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dq_d256_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                          const Params p) {
  static_assert(DMAX == D256, "this dQ runs at the head-dim width 256");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + DQ256_OFF_BARS;
  const uint32_t bar_full = bar_q + 8;    // + 8 * stage
  const uint32_t bar_empty = bar_q + 24;  // + 8 * stage
  int* scratch = reinterpret_cast<int*>(smem + DQ256_OFF_BARS + 40);
  unsigned char* tile_flags = smem + DQ256_OFF_LIST;
  short* tile_list = reinterpret_cast<short*>(tile_flags + MAX_TILES);

  const int b = blockIdx.z, h = blockIdx.y;  // h: the kv head
  const int BQ = BM / p.G;
  const int q0 = blockIdx.x * BQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NSTAGES; ++s) {
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
    mbar_expect_tx(bar_q, 2 * D256_Q_BYTES);
    for (int a = 0; a < D256_ATOMS; ++a) {
      tma_load_4d(base + a * ATOM_BYTES, &tm_q, bar_q, a * ATOM, h * p.G, q0, b);
      tma_load_4d(base + DQ256_OFF_DO + a * ATOM_BYTES, &tm_do, bar_q, a * ATOM, h * p.G, q0, b);
    }
  }
  // 64-key tiles, each walked as two 32-key stages
  const int n_stages = 2 * list_live_tiles<2 * DQ256_BN>(p.seg + static_cast<long long>(b) * p.S, p.S, p.window, q0,
                                                         BQ, scratch, tile_flags, tile_list);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    // lane 0 issues the TMA loads, the warp copies each stage's ids (1 a lane)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int lane = threadIdx.x;
    if (lane < 32) {
      for (int n = 0; n < n_stages; ++n) {
        const int st = n % NSTAGES;
        const int j0 = tile_list[n >> 1] * 2 * DQ256_BN + (n & 1) * DQ256_BN;
        mbar_wait(bar_empty + 8 * st, ((n / NSTAGES) & 1) ^ 1);  // the first round passes at once
        if (lane == 0) {
          mbar_expect_tx(bar_full + 8 * st, 2 * DQ256_KV_BYTES);
          for (int a = 0; a < D256_ATOMS; ++a) {
            tma_load_4d(base + DQ256_OFF_K + st * DQ256_KV_BYTES + a * DQ256_KV_ATOM, &tm_k, bar_full + 8 * st,
                        a * ATOM, h, j0, b);
            tma_load_4d(base + DQ256_OFF_V + st * DQ256_KV_BYTES + a * DQ256_KV_ATOM, &tm_v, bar_full + 8 * st,
                        a * ATOM, h, j0, b);
          }
        }
        const int j = j0 + lane;
        reinterpret_cast<int*>(smem + DQ256_OFF_SEG + st * DQ256_BN * 4)[lane] =
            j < p.S ? p.seg[static_cast<long long>(b) * p.S + j] : 0;
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

    float dq[2][64];  // the two 128-column halves of this thread's dQ
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[0][i] = dq[1][i] = 0.f;

    mbar_wait(bar_q, 0);
    const uint32_t q_tile = base + cw * 64 * 128;  // 64 rows x 128 bytes into each atom
    const uint32_t do_tile = base + DQ256_OFF_DO + cw * 64 * 128;

    for (int n = 0; n < n_stages; ++n) {
      const int st = n % NSTAGES;
      const int j0 = tile_list[n >> 1] * 2 * DQ256_BN + (n & 1) * DQ256_BN;
      mbar_wait(bar_full + 8 * st, (n / NSTAGES) & 1);
      const uint32_t k_tile = base + DQ256_OFF_K + st * DQ256_KV_BYTES;
      const uint32_t v_tile = base + DQ256_OFF_V + st * DQ256_KV_BYTES;

      // ---- S = Q K^T and dP = dO V^T: 16 k-steps of 16 columns each ----
      float s[DQ256_BN / 2], dp[DQ256_BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D256 / 16; ++kk) {
        const uint32_t oq = (kk / 4) * ATOM_BYTES + (kk % 4) * 32, okv = (kk / 4) * DQ256_KV_ATOM + (kk % 4) * 32;
        wgmma_m64n32k16_ss(s, sw128_desc(q_tile + oq, 1, 64), sw128_desc(k_tile + okv, 1, 64), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D256 / 16; ++kk) {
        const uint32_t oq = (kk / 4) * ATOM_BYTES + (kk % 4) * 32, okv = (kk / 4) * DQ256_KV_ATOM + (kk % 4) * 32;
        wgmma_m64n32k16_ss(dp, sw128_desc(do_tile + oq, 1, 64), sw128_desc(v_tile + okv, 1, 64), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // ---- is the stage interior for this thread's live rows? ----
      const int* kseg = reinterpret_cast<const int*>(smem + DQ256_OFF_SEG + st * DQ256_BN * 4);
      const int id = kseg[lane];
      const int kmin = __reduce_min_sync(0xffffffffu, id);
      const int kmax = __reduce_max_sync(0xffffffffu, id);
      bool interior = true;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (pos[hr] >= 0)
          interior = interior && kmin == sid[hr] && kmax == sid[hr] && j0 + DQ256_BN - 1 <= pos[hr] &&
                     (p.window <= 0 || pos[hr] - j0 < p.window);

      // ---- dS = P (dP - delta) scale, P = 0 off the live pairs ----
#pragma unroll
      for (int i = 0; i < DQ256_BN / 2; ++i) {
        const int hr = (i >> 1) & 1;
        float pr = exp2f(s[i] * p.scale_log2 - lse2[hr]);
        if (!interior) {
          const int c = 8 * (i / 4) + cq + (i & 1), j = j0 + c;
          const bool live = kseg[c] == sid[hr] && j <= pos[hr] && (p.window <= 0 || pos[hr] - j < p.window);
          if (!live) pr = 0.f;
        }
        s[i] = pr * (dp[i] - dlt[hr]) * p.scale;
      }

      // ---- dQ += dS K: 2 k-steps of 16 keys over K's two 128-column
      // halves (8-key groups 1024 bytes apart, a half's atoms DQ256_KV_ATOM
      // apart), dS from registers ----
      uint32_t da[DQ256_BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ256_BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) da[kk][c] = pack_bf16(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ256_BN / 16; ++kk) {
        wgmma_m64n128k16_rs(dq[0], da[kk], sw128_desc(k_tile + kk * 16 * 128, DQ256_KV_ATOM / 16, 64));
        wgmma_m64n128k16_rs(dq[1], da[kk],
                            sw128_desc(k_tile + 2 * DQ256_KV_ATOM + kk * 16 * 128, DQ256_KV_ATOM / 16, 64));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq[0]);
      fence_regs(dq[1]);
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
        for (int j = 0; j < D256 / 8; ++j) {
          const int col = 8 * j + cq, half = j / 16, jj = j % 16;
          if (col < p.D)
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                pos[hr] < 0 ? __floats2bfloat162_rn(0.f, 0.f)
                            : __floats2bfloat162_rn(dq[half][4 * jj + 2 * hr], dq[half][4 * jj + 2 * hr + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4's dK/dV at D = 256: 64 keys a CTA, dV in consumer 1, dK in consumer 2
// ---------------------------------------------------------------------------
//
// K and V load once (a 64-row box of each of the four atoms).  The CTA lists
// the 64-query tiles its live keys meet (list_live_tiles<DKV_BQ, true>); the
// producer warp walks them x the G query heads, lane 0 loading Q and dO into
// a ring of 2 stages and the warp copying the tile's segment ids, lse (log2
// units; +inf for a query of segment 0 or past S) and delta beside them.
// Per stage both consumer warpgroups compute S^T = K Q^T (16 wgmma
// m64n64k16) and P^T on the live pairs with dQ's interior test; warpgroup 1
// then adds bf16(P^T) dO to dV, warpgroup 2 computes dP^T = V dO^T too and
// adds bf16(dS^T) Q to dK, dS^T = P^T (dP^T - delta) scale from the
// unrounded P, as _bwd_dkv_kernel (:525, :535).  The GQA group sums in
// f32 registers, rounded once.  Keys of segment 0 store zeros, keys >= S
// nothing.  No atomics: deterministic.

constexpr int DKV256_BK = 64;                                     // keys per CTA
constexpr int DKV256_OFF_V = D256_KV_BYTES;                       // K at 0
constexpr int DKV256_OFF_Q = 2 * D256_KV_BYTES;                   // + stage * D256_KV_BYTES
constexpr int DKV256_OFF_DO = DKV256_OFF_Q + NSTAGES * D256_KV_BYTES;     // + stage * D256_KV_BYTES
constexpr int DKV256_OFF_SIDE = DKV256_OFF_DO + NSTAGES * D256_KV_BYTES;  // + stage * DKV_SIDE_BYTES
constexpr int DKV256_OFF_LIST = DKV256_OFF_SIDE + NSTAGES * DKV_SIDE_BYTES;
constexpr int DKV256_OFF_BARS = DKV256_OFF_LIST + TILE_LIST_BYTES;
// barriers (kv_full, full[2], empty[2]), list_live_tiles' 5 ints, alignment
constexpr int DKV256_SMEM_BYTES = DKV256_OFF_BARS + 64 + 1024;
static_assert(DKV256_SMEM_BYTES <= 227 * 1024, "the D = 256 dK/dV must fit one CTA's shared memory");

// one consumer warpgroup of flash_dkv_d256_sm90_kernel: DK false accumulates
// dV (warpgroup 1), DK true dK (warpgroup 2); each its own instantiation,
// so no wgmma sits under a runtime condition
template <bool DK>
__device__ __forceinline__ void dkv256_consumer(const unsigned char* smem, uint32_t base, uint32_t bar_kv,
                                                uint32_t bar_full, uint32_t bar_empty, const short* tile_list,
                                                int n_tiles, const Params& p, int b, int h, int j0, bf16* out) {
  const int G = p.G;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = 16 * warp + lane / 4;  // this thread's keys: r_lo and r_lo + 8
  const int cq = 2 * (lane % 4);          // its first query column in each group of 8

  // position and segment of this thread's two keys; a key of segment 0 or
  // past S has position INT_MAX (no query is live for it) and stores zeros
  int kpos[2], ksid[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = j0 + r_lo + 8 * hr;
    ksid[hr] = j < p.S ? p.seg[static_cast<long long>(b) * p.S + j] : 0;
    kpos[hr] = ksid[hr] != 0 ? j : INT_MAX;
  }

  float acc[2][64];  // the two 128-column halves of this thread's dV or dK
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;

  mbar_wait(bar_kv, 0);
  const uint32_t k_tile = base, v_tile = base + DKV256_OFF_V;

  int st = 0;
  uint32_t ph = 0;
  for (int n = 0, t = 0, g = 0; n < n_tiles * G; ++n) {
    const int i0 = tile_list[t] * DKV_BQ;
    mbar_wait(bar_full + 8 * st, ph);
    const uint32_t q_tile = base + DKV256_OFF_Q + st * D256_KV_BYTES;
    const uint32_t do_tile = base + DKV256_OFF_DO + st * D256_KV_BYTES;

    // ---- S^T = K Q^T (and, for dK, dP^T = V dO^T): 16 k-steps each ----
    float s[DKV_BQ / 2], dp[DKV_BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D256 / 16; ++kk) {
      const uint32_t o = (kk / 4) * D256_KV_ATOM + (kk % 4) * 32;
      wgmma_m64n64k16_ss(s, sw128_desc(k_tile + o, 1, 64), sw128_desc(q_tile + o, 1, 64), kk > 0);
    }
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < D256 / 16; ++kk) {
        const uint32_t o = (kk / 4) * D256_KV_ATOM + (kk % 4) * 32;
        wgmma_m64n64k16_ss(dp, sw128_desc(v_tile + o, 1, 64), sw128_desc(do_tile + o, 1, 64), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    if constexpr (DK) fence_regs(dp);

    // ---- is the tile interior for this thread's live keys? ----
    const unsigned char* side = smem + DKV256_OFF_SIDE + st * DKV_SIDE_BYTES;
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

    // ---- P^T on the live pairs; for dK, dS^T = P^T (dP^T - delta) scale ----
#pragma unroll
    for (int i = 0; i < DKV_BQ / 2; ++i) {
      const int hr = (i >> 1) & 1, c = 8 * (i / 4) + cq + (i & 1);
      float pr = exp2f(s[i] * p.scale_log2 - lse2[c]);
      if (!interior) {
        const int qi = i0 + c;
        const bool live = qseg[c] == ksid[hr] && kpos[hr] <= qi && (p.window <= 0 || qi - kpos[hr] < p.window);
        if (!live) pr = 0.f;
      }
      if constexpr (DK)
        s[i] = pr * (dp[i] - dlt[c]) * p.scale;
      else
        s[i] = pr;
    }

    // ---- dV += bf16(P^T) dO or dK += bf16(dS^T) Q: 4 k-steps of 16
    // queries over the operand's two 128-column halves, read MN-major
    // (8-query groups 1024 bytes apart, a half's atoms D256_KV_ATOM apart) ----
    uint32_t pa[DKV_BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) pa[kk][c] = pack_bf16(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
    const uint32_t b_tile = DK ? q_tile : do_tile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
      wgmma_m64n128k16_rs(acc[0], pa[kk], sw128_desc(b_tile + kk * 16 * 128, D256_KV_ATOM / 16, 64));
      wgmma_m64n128k16_rs(acc[1], pa[kk],
                          sw128_desc(b_tile + 2 * D256_KV_ATOM + kk * 16 * 128, D256_KV_ATOM / 16, 64));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    mbar_arrive(bar_empty + 8 * st);
    if (++st == NSTAGES) {
      st = 0;
      ph ^= 1;
    }
    if (++g == G) {  // the next query tile
      g = 0;
      ++t;
    }
  }

  // ---- epilogue: bf16 dK or dV into the contiguous (B, S, Hk, D) output ----
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = j0 + r_lo + 8 * hr;
    if (key < p.S) {
      bf16* dst = out + b * p.sob + key * p.sos + h * p.soh;
      const bool dead = kpos[hr] == INT_MAX;
#pragma unroll
      for (int j = 0; j < D256 / 8; ++j) {
        const int col = 8 * j + cq, half = j / 16, jj = j % 16;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              dead ? __floats2bfloat162_rn(0.f, 0.f)
                   : __floats2bfloat162_rn(acc[half][4 * jj + 2 * hr], acc[half][4 * jj + 2 * hr + 1]);
      }
    }
  }
}

template <int DMAX>  // 256: instantiated only where it is launched (flash_attention_sm90.cu)
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dkv_d256_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                           const Params p, bf16* dv_out) {
  static_assert(DMAX == D256, "this dK/dV runs at the head-dim width 256");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                         ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_kv = base + DKV256_OFF_BARS;
  const uint32_t bar_full = bar_kv + 8;    // + 8 * stage
  const uint32_t bar_empty = bar_kv + 24;  // + 8 * stage
  int* scratch = reinterpret_cast<int*>(smem + DKV256_OFF_BARS + 40);
  unsigned char* tile_flags = smem + DKV256_OFF_LIST;
  short* tile_list = reinterpret_cast<short*>(tile_flags + MAX_TILES);

  const int b = blockIdx.z, h = blockIdx.y;  // h: the kv head
  const int j0 = blockIdx.x * DKV256_BK;     // the CTA's first key
  const int G = p.G;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < NSTAGES; ++s) {
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
    mbar_expect_tx(bar_kv, 2 * D256_KV_BYTES);
    for (int a = 0; a < D256_ATOMS; ++a) {
      tma_load_4d(base + a * D256_KV_ATOM, &tm_k, bar_kv, a * ATOM, h, j0, b);
      tma_load_4d(base + DKV256_OFF_V + a * D256_KV_ATOM, &tm_v, bar_kv, a * ATOM, h, j0, b);
    }
  }
  const int n_tiles = list_live_tiles<DKV_BQ, true>(p.seg + static_cast<long long>(b) * p.S, p.S, p.window, j0,
                                                    DKV256_BK, scratch, tile_flags, tile_list);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
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
            mbar_expect_tx(bar_full + 8 * st, 2 * D256_KV_BYTES);
            for (int a = 0; a < D256_ATOMS; ++a) {
              tma_load_4d(base + DKV256_OFF_Q + st * D256_KV_BYTES + a * D256_KV_ATOM, &tm_q, bar_full + 8 * st,
                          a * ATOM, hq, i0, b);
              tma_load_4d(base + DKV256_OFF_DO + st * D256_KV_BYTES + a * D256_KV_ATOM, &tm_do, bar_full + 8 * st,
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
          unsigned char* side = smem + DKV256_OFF_SIDE + st * DKV_SIDE_BYTES;
          reinterpret_cast<int2*>(side)[lane] = make_int2(ids[0], ids[1]);
          reinterpret_cast<float2*>(side + DKV_BQ * 4)[lane] = make_float2(lse2[0], lse2[1]);
          reinterpret_cast<float2*>(side + 2 * DKV_BQ * 4)[lane] = make_float2(dlt[0], dlt[1]);
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_full + 8 * st);
          if (++st == NSTAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    if (wg == 1)
      dkv256_consumer<false>(smem, base, bar_kv, bar_full, bar_empty, tile_list, n_tiles, p, b, h, j0, dv_out);
    else
      dkv256_consumer<true>(smem, base, bar_kv, bar_full, bar_empty, tile_list, n_tiles, p, b, h, j0, p.out);
  }
}

}  // namespace sm90
}  // namespace srgpt

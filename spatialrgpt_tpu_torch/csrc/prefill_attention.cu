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
// attention_d256.cuh::d256_fwd_sm90_kernel<PREFILL> (K4's D = 256 forward is
// the same template in mode FLASH_FWD), the same fold, mask, tile range and
// producer / consumer split on 64-key tiles; its design is in that header.

#include "attention_d256.cuh"

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
  auto kern = d256_fwd_sm90_kernel<PREFILL>;
  constexpr int bytes = d256_smem_bytes(PREFILL);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, NTHREADS, bytes, st>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

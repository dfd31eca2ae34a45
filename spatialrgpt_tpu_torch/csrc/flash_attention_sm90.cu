// K4: FlashAttention-2 forward, dQ and dK/dV for packed-segment causal GQA
// with an optional sliding window (the training step's attention at S =
// 4096).
//
// Replaces the Pallas kernels of
// spatialrgpt_tpu/ops/flash_attention.py::flash_attention: the forward
// (_fwd / _fwd_kernel) and the two kernels of _flash_bwd (_bwd_dkv_kernel,
// _bwd_dq_kernel).
//
// Bound on the H100: tensor-core FLOPs.  At the align step's shape (B = 4,
// S = 4096, Hq = 32, Hk = 8, D = 128, 4 packed samples of ~1000 tokens per
// row) the live causal x segment pairs are ~4 x 1000^2 / 2 per (row, head):
// the forward does ~136 GFLOP (0.14 ms at 989 TFLOP/s), dQ 1.5x that and
// dK/dV 2x, against ~0.2-0.3 GB of q/k/v/o/dO traffic per call.  So the
// products run on wgmma, and tiles that hold no live pair are never loaded.
//
// Design: the Hopper main loop of attention_sm90.cuh at a head-dim width of
// 128, with K2's GQA fold (G = Hq / Hk query heads x 128 / G positions of
// one kv head per CTA; at llama3-8b 32 positions and a grid of 128 x 8 x 4),
// its in-kernel mask (key j is live for query i iff seg[j] == seg[i] != 0,
// j <= i and (window <= 0 or i - j < window)) and maskless interior tiles.
// Each CTA first lists the key tiles that hold a key of its live queries'
// segments (list_live_tiles), so a row of 4 packed samples costs each CTA
// only its own sample's tiles.
//  - forward: mode FLASH_FWD, K2's kernel plus the LSE, (B, Hq, S) f32,
//    (m + log2 l) ln 2 in the exp2 domain, -1e30 for a row of segment 0.
//  - dQ: flash_dq_sm90_kernel, the same loop over 64-key tiles with S =
//    Q K^T and dP = dO V^T from shared memory, dS = P (dP - delta) scale
//    rounded to bf16 in registers, dQ += dS K.  delta = rowsum(dO * O) is a
//    plain torch reduction in the wrapper, as the reference computes it in
//    XLA.
//  - dK/dV: flash_dkv_sm90_kernel, the key-stationary mirror of dQ: 128
//    keys of one kv head per CTA (64 per consumer warpgroup) stay in
//    shared memory while the producer walks the listed 64-query tiles x
//    the G query heads; dK and dV of the whole group accumulate in
//    registers.  No fold, so any G = Hq / Hk.
// q/k/v/dO/out go through the caller's (B, S, H, D) strides; any S up to
// 65,536 (MAX_TILES tiles of 64), D <= 128 with D % 8 == 0 (TMA
// zero-fills the head dim to 128).

#include "attention_sm90.cuh"

using namespace srgpt::sm90;

namespace {

bool fold_ok(int B, int S, int Hq, int Hk, int D) {
  return B > 0 && S > 0 && S <= MAX_TILES * DQ_BN && Hk > 0 && Hq % Hk == 0 && BM % (Hq / Hk) == 0 && D > 0 &&
         D % 8 == 0 && D <= WIDE;
}

Params fold_params(void* out, long long sob, long long sos, long long soh, const void* seg, int S, int Hq, int Hk,
                   int D, int window, float sm_scale) {
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
  p.scale = sm_scale;
  p.seg = static_cast<const int*>(seg);
  p.G = Hq / Hk;
  p.window = window;
  return p;
}

}  // namespace

extern "C" int srgpt_flash_fwd(
    const void* q, const void* k, const void* v, const void* seg, void* out, void* lse,
    int B, int S, int Hq, int Hk, int D,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    int window, float sm_scale, void* stream) {
  if (!fold_ok(B, S, Hq, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = fold_params(out, sob, sos, soh, seg, S, Hq, Hk, D, window, sm_scale);
  p.lse = static_cast<float*>(lse);
  const int G = p.G;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, S, Hq, D, sqb, sqs, sqh, G, BM / G);
  if (err == cudaSuccess) err = make_map(&tk, k, B, S, Hk, D, skb, sks, skh);
  if (err == cudaSuccess) err = make_map(&tv, v, B, S, Hk, D, svb, svs, svh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BM / G - 1) / (BM / G), Hk, B);
  return static_cast<int>(launch_kernel<WIDE, FLASH_FWD>(tq, tk, tv, p, grid, static_cast<cudaStream_t>(stream)));
}

// dq: (B, S, Hq, D) bf16, contiguous
extern "C" int srgpt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    const void* seg, void* dq,
    int B, int S, int Hq, int Hk, int D,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sdb, long long sds, long long sdh,
    int window, float sm_scale, void* stream) {
  if (!fold_ok(B, S, Hq, Hk, D)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = fold_params(dq, static_cast<long long>(S) * Hq * D, static_cast<long long>(Hq) * D, D, seg, S, Hq, Hk,
                         D, window, sm_scale);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  const int G = p.G;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = make_map(&tq, q, B, S, Hq, D, sqb, sqs, sqh, G, BM / G);
  if (err == cudaSuccess) err = make_map(&tdo, dout, B, S, Hq, D, sdb, sds, sdh, G, BM / G);
  if (err == cudaSuccess) err = make_map(&tk, k, B, S, Hk, D, skb, sks, skh, 1, DQ_BN);
  if (err == cudaSuccess) err = make_map(&tv, v, B, S, Hk, D, svb, svs, svh, 1, DQ_BN);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = flash_dq_sm90_kernel<WIDE>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BM / G - 1) / (BM / G), Hk, B);
  kern<<<grid, NTHREADS, DQ_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(tq, tdo, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv: (B, S, Hk, D) bf16, contiguous
extern "C" int srgpt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    const void* seg, void* dk, void* dv,
    int B, int S, int Hq, int Hk, int D,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sdb, long long sds, long long sdh,
    int window, float sm_scale, void* stream) {
  if (!(B > 0 && S > 0 && S <= MAX_TILES * DKV_BQ && Hk > 0 && Hq % Hk == 0 && D > 0 && D % 8 == 0 && D <= WIDE))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = fold_params(dk, static_cast<long long>(S) * Hk * D, static_cast<long long>(Hk) * D, D, seg, S, Hq, Hk,
                         D, window, sm_scale);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = make_map(&tq, q, B, S, Hq, D, sqb, sqs, sqh, 1, DKV_BQ);
  if (err == cudaSuccess) err = make_map(&tdo, dout, B, S, Hq, D, sdb, sds, sdh, 1, DKV_BQ);
  if (err == cudaSuccess) err = make_map(&tk, k, B, S, Hk, D, skb, sks, skh);
  if (err == cudaSuccess) err = make_map(&tv, v, B, S, Hk, D, svb, svs, svh);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = flash_dkv_sm90_kernel<WIDE>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BM - 1) / BM, Hk, B);
  kern<<<grid, NTHREADS, DKV_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(tq, tdo, tk, tv, p, static_cast<bf16*>(dv));
  return static_cast<int>(cudaGetLastError());
}

// K2: causal x packed-segment (x sliding-window) prefill attention, GQA.
//
// Replaces the Pallas kernel
// spatialrgpt_tpu/ops/prefill_attention.py::onepass_attention (_onepass / _kernel).
//
// Bound on the H100: at the llama3-8b prefill shape (B = 8, S = 320,
// Hq = 32, Hk = 8, D = 128) a call does ~6.7 GFLOP of causal products
// (7 us at 989 TFLOP/s) and moves ~52 MB of q/k/v/out (16 us at
// 3.35 TB/s): both floors are far below what a simple kernel reaches, and
// the part that scales with S is the tensor-core work, which is why the
// products run on the tensor cores and K/V are read once per kv head.
//
// Design: one CTA per (q tile, kv head, batch) serves the G = Hq / Hk query
// heads that share that kv head (the Pallas kernel's fold_g): its 64 rows
// are G heads x 64/G positions, so K and V are read once at kv-head width.
// The causal x segment x window mask is built in the kernel from the
// segment ids (no (B, S, S) bias is streamed): key j is live for query i
// iff seg[j] == seg[i] != 0, j <= i and (window <= 0 or i - j < window).
// Key tiles wholly above the diagonal or outside the window are skipped.
// A row with no live key (segment 0) writes zeros.  Any S is taken.

#include "attention_tile.cuh"

namespace srgpt {

struct PrefillPolicy {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* seg;  // (B, S) int32, contiguous
  bf16* out;
  Strides sq, sk, sv, so;
  int S;
  int G;       // query heads per kv head; divides BM
  int window;  // <= 0: none

  __device__ int b() const { return blockIdx.z; }
  __device__ int hk() const { return blockIdx.y; }
  __device__ int bq() const { return BM / G; }
  __device__ int q_lo() const { return blockIdx.x * bq(); }
  __device__ int row_pos(int r) const { return q_lo() + r % bq(); }
  __device__ int row_head(int r) const { return hk() * G + r / bq(); }

  // rowmeta[2r] = query position (or -1 past S), rowmeta[2r+1] = its segment
  __device__ void init_rows(int* rowmeta) const {
    for (int r = threadIdx.x; r < BM; r += NTHREADS) {
      const int i = row_pos(r);
      rowmeta[2 * r] = i < S ? i : -1;
      rowmeta[2 * r + 1] = i < S ? seg[b() * S + i] : 0;
    }
  }
  __device__ const bf16* q_row(const int* rowmeta, int r) const {
    const int i = rowmeta[2 * r];
    return i >= 0 ? q + b() * sq.b + i * sq.s + row_head(r) * sq.h : nullptr;
  }
  __device__ int key_tile_begin() const {
    if (window <= 0) return 0;
    const int lo = q_lo() - window + 1;
    return lo > 0 ? lo / BN : 0;
  }
  __device__ int key_tile_end() const {
    int hi = q_lo() + bq();  // exclusive bound on live keys (causal)
    if (hi > S) hi = S;
    return (hi + BN - 1) / BN;
  }
  __device__ const bf16* k_row(int j) const { return k + b() * sk.b + j * sk.s + hk() * sk.h; }
  __device__ const bf16* v_row(int j) const { return v + b() * sv.b + j * sv.s + hk() * sv.h; }
  __device__ void init_keys(int* keymeta, int j0) const {
    for (int jj = threadIdx.x; jj < BN; jj += NTHREADS) {
      const int j = j0 + jj;
      keymeta[jj] = j < S ? seg[b() * S + j] : 0;
    }
  }
  __device__ bool live(const int* rowmeta, const int* keymeta, int r, int jj, int j) const {
    const int i = rowmeta[2 * r];
    const int si = rowmeta[2 * r + 1];
    return i >= 0 && si != 0 && j <= i && keymeta[jj] == si && (window <= 0 || i - j < window);
  }
  __device__ bf16* out_row(const int* rowmeta, int r) const {
    const int i = rowmeta[2 * r];
    return i >= 0 ? out + b() * so.b + i * so.s + row_head(r) * so.h : nullptr;
  }
};

template <int DP>
struct PrefillLaunch {
  static cudaError_t run(PrefillPolicy pol, int B, int Hk, int D, float sm_scale, cudaStream_t stream) {
    const int bq = BM / pol.G;
    dim3 grid((pol.S + bq - 1) / bq, Hk, B);
    return launch_tile<DP>(pol, grid, pol.S, D, sm_scale, stream);
  }
};

}  // namespace srgpt

extern "C" int srgpt_prefill_attention(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    int B, int S, int Hq, int Hk, int D,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    int window, float sm_scale, void* stream) {
  using namespace srgpt;
  if (Hk <= 0 || Hq % Hk != 0 || BM % (Hq / Hk) != 0) return static_cast<int>(cudaErrorInvalidValue);
  PrefillPolicy pol;
  pol.q = static_cast<const bf16*>(q);
  pol.k = static_cast<const bf16*>(k);
  pol.v = static_cast<const bf16*>(v);
  pol.seg = static_cast<const int*>(seg);
  pol.out = static_cast<bf16*>(out);
  pol.sq = {sqb, sqs, sqh};
  pol.sk = {skb, sks, skh};
  pol.sv = {svb, svs, svh};
  pol.so = {sob, sos, soh};
  pol.S = S;
  pol.G = Hq / Hk;
  pol.window = window;
  return static_cast<int>(dispatch_dp<PrefillLaunch>(D, pol, B, Hk, D, sm_scale,
                                                     static_cast<cudaStream_t>(stream)));
}

// K1: non-causal whole-sequence attention for the ViT towers.
//
// Replaces the Pallas kernel spatialrgpt_tpu/ops/vit_attention.py::vit_attention
// (_vit_attn / _kernel, and the layout experiment _vit_attn_nt / _nt_kernel).
//
// Bound on the H100: tensor-core FLOPs.  At the SigLIP-so400m shape
// (S = 729, H = 16, D = 72) every (b, h) does 2 * 2 * 729^2 * 72 FLOPs
// against ~0.3 MB of q/k/v reads: ~490 FLOPs per byte, above the card's
// ~295 FLOP/byte bf16 ridge (39 GFLOP per call at B = 16: 40 us at
// 989 TFLOP/s).
//
// Design: one CTA per (q tile of 64 rows, head, batch) reads q/k/v through
// their (B, S, H, D) strides -- no transpose and no pad copy in device
// memory, which is what the Pallas version needed two kernels for.  D = 72
// is padded to 80 inside shared memory with masked loads.  Keys stream in
// tiles of 64 with an online softmax (the Pallas kernel held the whole
// 768-padded row in VMEM; 227 KB of shared memory cannot), bf16 WMMA
// products with fp32 accumulation, and keys >= valid_len are masked, which
// covers the ragged 729 and callers that pre-pad.

#include "attention_tile.cuh"

namespace srgpt {

struct VitPolicy {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  Strides sq, sk, sv, so;
  int S;
  int valid_len;

  __device__ int b() const { return blockIdx.z; }
  __device__ int h() const { return blockIdx.y; }
  __device__ int row_pos(int r) const { return blockIdx.x * BM + r; }

  __device__ void init_rows(int*) const {}
  __device__ const bf16* q_row(const int*, int r) const {
    const int i = row_pos(r);
    return i < S ? q + b() * sq.b + i * sq.s + h() * sq.h : nullptr;
  }
  __device__ int key_tile_begin() const { return 0; }
  __device__ int key_tile_end() const { return (valid_len + BN - 1) / BN; }
  __device__ const bf16* k_row(int j) const { return k + b() * sk.b + j * sk.s + h() * sk.h; }
  __device__ const bf16* v_row(int j) const { return v + b() * sv.b + j * sv.s + h() * sv.h; }
  __device__ void init_keys(int*, int) const {}
  __device__ bool live(const int*, const int*, int r, int, int j) const {
    return j < valid_len && row_pos(r) < S;
  }
  __device__ bf16* out_row(const int*, int r) const {
    const int i = row_pos(r);
    return i < S ? out + b() * so.b + i * so.s + h() * so.h : nullptr;
  }
};

template <int DP>
struct VitLaunch {
  static cudaError_t run(VitPolicy pol, int B, int H, int D, float sm_scale, cudaStream_t stream) {
    dim3 grid((pol.S + BM - 1) / BM, H, B);
    return launch_tile<DP>(pol, grid, pol.S, D, sm_scale, stream);
  }
};

}  // namespace srgpt

extern "C" int srgpt_vit_attention(
    const void* q, const void* k, const void* v, void* out,
    int B, int S, int H, int D,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    int valid_len, float sm_scale, void* stream) {
  using namespace srgpt;
  VitPolicy pol;
  pol.q = static_cast<const bf16*>(q);
  pol.k = static_cast<const bf16*>(k);
  pol.v = static_cast<const bf16*>(v);
  pol.out = static_cast<bf16*>(out);
  pol.sq = {sqb, sqs, sqh};
  pol.sk = {skb, sks, skh};
  pol.sv = {svb, svs, svh};
  pol.so = {sob, sos, soh};
  pol.S = S;
  pol.valid_len = valid_len;
  return static_cast<int>(dispatch_dp<VitLaunch>(D, pol, B, H, D, sm_scale,
                                                 static_cast<cudaStream_t>(stream)));
}

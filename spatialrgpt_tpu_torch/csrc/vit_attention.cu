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
// Design: the Hopper main loop of attention_sm90.cuh (TMA loads into a
// 2-stage K/V ring, a producer warpgroup and two wgmma consumer
// warpgroups, softmax and O in registers).  q/k/v are read through their
// (B, S, H, D) strides by 4-D tensor maps -- no transpose and no pad copy
// in device memory, which is what the Pallas version needed two kernels
// for.  D = 72 (and CLIP's 64) is padded to 80 by TMA's zero fill; 80 < D
// <= 128 (InternViT-6B's 128) runs the loop at its 128-wide form, K2's
// width.  Keys >= valid_len are masked on the last key tile only (the
// ragged 729, and callers that pre-pad); at S = 729 that is 6 key tiles per
// CTA and a grid of 6 x 16 x 16; at InternViT's S = 1025 the last tile holds
// one live key.

#include "attention_sm90.cuh"

extern "C" int srgpt_vit_attention(
    const void* q, const void* k, const void* v, void* out,
    int B, int S, int H, int D,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    int valid_len, float sm_scale, void* stream) {
  using namespace srgpt::sm90;
  Params p{};
  p.out = static_cast<bf16*>(out);
  p.sob = sob;
  p.sos = sos;
  p.soh = soh;
  p.S = S;
  p.H = H;
  p.D = D;
  p.kv_len = valid_len;
  p.scale_log2 = sm_scale * LOG2E;
  return static_cast<int>(launch<NO_BIAS>({q, sqb, sqs, sqh}, {k, skb, sks, skh}, {v, svb, svs, svh}, p, B,
                                        static_cast<cudaStream_t>(stream)));
}

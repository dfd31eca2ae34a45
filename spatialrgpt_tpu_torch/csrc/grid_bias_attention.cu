// K5: attention with SAM ViT-det's decomposed relative-position bias
// (the global-attention layers of the SAM image encoder), forward only.
//
// Replaces the Pallas kernel
// spatialrgpt_tpu/ops/flash_attention.py::grid_bias_attention
// (_fwd_grid_bias_kernel).  Over an S = gh * gw token grid,
//   score[i, j] = q_i . k_j * sm_scale + rel_h[i, j / gw] + rel_w[i, j % gw]
// (HF adds the bias, built from the unscaled q, after the scaling).
//
// Bound on the H100: tensor-core FLOPs.  At SAM vit_h (B = 4 images,
// S = 4096 on a 64 x 64 grid, H = 16, D = 80) a call does
// 2 * 2 * 4096^2 * 80 FLOPs per (b, h), 344 GFLOP (0.35 ms at
// 989 TFLOP/s), against 42 MB of q/k/v/out and 134 MB of f32 bias reads.
//
// Design: the Hopper main loop of attention_sm90.cuh with its bias branch.
// At CTA start each consumer warpgroup copies its 64 query rows of rel_h
// (64 x gh f32) and rel_w (64 x gw f32) into shared memory, scaled by
// log2(e) for the exp2-domain softmax (64 KB for the CTA at gh = gw = 64,
// so gh and gw are at most 64); each score then adds
// rel_h[r][j / gw] + rel_w[r][j % gw] from there, after the scale.  Any
// grid width works (tested at 64, 48 and 13) without the Pallas kernel's
// rule that a key block covers whole grid rows, and without its
// iota-selector matmuls (Mosaic layout rules).  q/k/v are views into the
// fused qkv projection, read through their strides by the tensor maps.
// At S = 4096: 32 key tiles per CTA, a grid of 32 x 16 x 4.

#include "attention_sm90.cuh"

extern "C" int srgpt_grid_bias_attention(
    const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w, void* out,
    int B, int S, int H, int D, int gh, int gw,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    float sm_scale, void* stream) {
  using namespace srgpt::sm90;
  if (gh <= 0 || gw <= 0 || gh > BIAS_LD || gw > BIAS_LD || gh * gw != S)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.out = static_cast<bf16*>(out);
  p.sob = sob;
  p.sos = sos;
  p.soh = soh;
  p.S = S;
  p.H = H;
  p.D = D;
  p.kv_len = S;
  p.scale_log2 = sm_scale * LOG2E;
  p.rel_h = static_cast<const float*>(rel_h);
  p.rel_w = static_cast<const float*>(rel_w);
  p.gh = gh;
  p.gw = gw;
  const Operand oq{q, sqb, sqs, sqh}, ok{k, skb, sks, skh}, ov{v, svb, svs, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gw == 64 ? launch<GRID64>(oq, ok, ov, p, B, st) : launch<GRID>(oq, ok, ov, p, B, st));
}

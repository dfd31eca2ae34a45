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
// 989 TFLOP/s), against ~63 MB of q/k/v/out and 134 MB of f32 bias reads.
//
// Design: a fourth policy of attention_tile.cuh (one CTA per 64 query
// rows, head, image; 64-key tiles; WMMA bf16 with f32 accumulation; q/k/v
// read through their (B, S, H, D) strides; D = 80 needs no padding, vit_b's
// D = 64 pads to 80 in shared memory).  The policy's score_bias hook adds
// the two bias terms to each live score after sm_scale; init_keys stores
// each key's grid row j / gw once per tile, so any gw works (the Pallas
// kernel's rule that a key block covers whole grid rows, and its
// iota-selector matmuls, are Mosaic layout rules, not needed here).  The
// bias is read from global memory (L1/L2): at gw = 64 a key tile is one
// grid row, one rel_h value and one 64-wide rel_w row per query row.

#include "attention_tile.cuh"

namespace srgpt {

struct GridBiasPolicy {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* rel_h;  // (B, H, S, gh) f32, contiguous
  const float* rel_w;  // (B, H, S, gw) f32, contiguous
  bf16* out;
  Strides sq, sk, sv, so;
  int S;
  int H;
  int gh;
  int gw;

  __device__ int b() const { return blockIdx.z; }
  __device__ int h() const { return blockIdx.y; }
  __device__ int row_pos(int r) const { return blockIdx.x * BM + r; }

  __device__ void init_rows(int*) const {}
  __device__ const bf16* q_row(const int*, int r) const {
    const int i = row_pos(r);
    return i < S ? q + b() * sq.b + i * sq.s + h() * sq.h : nullptr;
  }
  __device__ int key_tile_begin() const { return 0; }
  __device__ int key_tile_end() const { return (S + BN - 1) / BN; }
  __device__ const bf16* k_row(int j) const { return k + b() * sk.b + j * sk.s + h() * sk.h; }
  __device__ const bf16* v_row(int j) const { return v + b() * sv.b + j * sv.s + h() * sv.h; }
  // keymeta[jj] = grid row of key j0 + jj
  __device__ void init_keys(int* keymeta, int j0) const {
    for (int jj = threadIdx.x; jj < BN; jj += NTHREADS) {
      const int j = j0 + jj;
      keymeta[jj] = j < S ? j / gw : 0;
    }
  }
  __device__ bool live(const int*, const int*, int r, int, int j) const { return j < S && row_pos(r) < S; }
  __device__ float score_bias(const int*, const int* keymeta, int r, int jj, int j) const {
    const long long row = (static_cast<long long>(b()) * H + h()) * S + row_pos(r);
    const int kh = keymeta[jj];
    return rel_h[row * gh + kh] + rel_w[row * gw + (j - kh * gw)];
  }
  __device__ bf16* out_row(const int*, int r) const {
    const int i = row_pos(r);
    return i < S ? out + b() * so.b + i * so.s + h() * so.h : nullptr;
  }
};

template <int DP>
struct GridBiasLaunch {
  static cudaError_t run(GridBiasPolicy pol, int B, int D, float sm_scale, cudaStream_t stream) {
    dim3 grid((pol.S + BM - 1) / BM, pol.H, B);
    return launch_tile<DP>(pol, grid, pol.S, D, sm_scale, stream);
  }
};

}  // namespace srgpt

extern "C" int srgpt_grid_bias_attention(
    const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w, void* out,
    int B, int S, int H, int D, int gh, int gw,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    float sm_scale, void* stream) {
  using namespace srgpt;
  if (gh <= 0 || gw <= 0 || gh * gw != S) return static_cast<int>(cudaErrorInvalidValue);
  GridBiasPolicy pol;
  pol.q = static_cast<const bf16*>(q);
  pol.k = static_cast<const bf16*>(k);
  pol.v = static_cast<const bf16*>(v);
  pol.rel_h = static_cast<const float*>(rel_h);
  pol.rel_w = static_cast<const float*>(rel_w);
  pol.out = static_cast<bf16*>(out);
  pol.sq = {sqb, sqs, sqh};
  pol.sk = {skb, sks, skh};
  pol.sv = {svb, svs, svh};
  pol.so = {sob, sos, soh};
  pol.S = S;
  pol.H = H;
  pol.gh = gh;
  pol.gw = gw;
  return static_cast<int>(dispatch_dp<GridBiasLaunch>(D, pol, B, D, sm_scale,
                                                      static_cast<cudaStream_t>(stream)));
}

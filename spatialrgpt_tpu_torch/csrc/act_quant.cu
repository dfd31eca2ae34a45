// K7: dynamic per-token int8 quantization of the activations of a W8A8
// projection.
//
// Replaces the prologue of spatialrgpt_tpu/ops/layers.py::_w8a8_dot (XLA in
// the reference, layers.py:30-35): per row of x (M, K),
//   amax = max |x|,  ascale = max(amax / 127, 1e-12),
//   xq = clip(round_half_even(x / ascale), -127, 127)  -> int8 (M, K), f32 (M,).
//
// Bound on the H100: bytes.  It reads 2 bytes and writes 1 per element
// (prefill, M 20,480 x K 4096: 252 MB, 75 us at 3.35 TB/s) and does a few
// operations per element.
//
// Design: one CTA of 128 threads per row.  Pass 1 reads the row in 16-byte
// vectors (8 bf16) and reduces |x| to the row max (warp shuffles, then one
// value per warp in shared memory).  Pass 2 reads the row again (from L1 /
// L2: a row is at most 28 KB) and writes 8 int8 a thread at a time.  The
// arithmetic is the reference's as XLA compiles it, bit for bit: the scale
// is max|x| times f32(1/127) (XLA folds the division by the constant into
// that multiply), x / scale an IEEE division (__fdiv_rn; the build has no
// --use_fast_math), rintf's round half to even, the clamp, then the cast.
// K % 8 == 0 and 16-byte aligned rows (the wrapper's rule).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srgpt {

constexpr int AQ_THREADS = 128;

__device__ __forceinline__ int8_t aq_quant(float x, float ascale) {
  float r = rintf(__fdiv_rn(x, ascale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

__global__ void __launch_bounds__(AQ_THREADS) act_quant_kernel(const __nv_bfloat16* __restrict__ x,
                                                                int8_t* __restrict__ xq,
                                                                float* __restrict__ ascale, int K) {
  __shared__ float warp_max[AQ_THREADS / 32];
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * K);
  const int vecs = K / 8;

  float m = 0.0f;
  for (int c = threadIdx.x; c < vecs; c += AQ_THREADS) {
    const uint4 v = xr[c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < AQ_THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
  const float s = fmaxf(__fmul_rn(m, 1.0f / 127.0f), 1e-12f);
  if (threadIdx.x == 0) ascale[row] = s;

  uint2* qr = reinterpret_cast<uint2*>(xq + row * K);
  for (int c = threadIdx.x; c < vecs; c += AQ_THREADS) {
    const uint4 v = xr[c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint32_t w[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 a = __bfloat1622float2(h[2 * half]);
      const float2 b = __bfloat1622float2(h[2 * half + 1]);
      w[half] = static_cast<uint32_t>(static_cast<uint8_t>(aq_quant(a.x, s))) |
                static_cast<uint32_t>(static_cast<uint8_t>(aq_quant(a.y, s))) << 8 |
                static_cast<uint32_t>(static_cast<uint8_t>(aq_quant(b.x, s))) << 16 |
                static_cast<uint32_t>(static_cast<uint8_t>(aq_quant(b.y, s))) << 24;
    }
    qr[c] = make_uint2(w[0], w[1]);
  }
}

}  // namespace srgpt

extern "C" int srgpt_act_quant(const void* x, void* xq, void* ascale, long long M, int K, void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  srgpt::act_quant_kernel<<<static_cast<unsigned>(M), srgpt::AQ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(ascale), K);
  return static_cast<int>(cudaGetLastError());
}

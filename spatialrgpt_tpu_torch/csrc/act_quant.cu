// K7: dynamic per-token int8 quantization of the activations of a W8A8
// projection, and K10: the same of the scaled output gradient in the int8
// backward of that projection.
//
// K7 replaces the prologue of spatialrgpt_tpu/ops/layers.py::_w8a8_dot (XLA in
// the reference, layers.py:30-35): per row of x (M, K),
//   amax = max |x|,  ascale = max(amax / 127, 1e-12),
//   xq = clip(round_half_even(x / ascale), -127, 127)  -> int8 (M, K), f32 (M,).
// K10 replaces the prologue of the SwitchBack dx in _w8a8_dot_bwd
// (layers.py:70-73): per row of dy (M, N) with the weight's f32 scale (N,),
//   dyf = f32(dy) * scale[n],  gscale = max(max |dyf| / 127, 1e-30),
//   dyq = clip(round_half_even(dyf / gscale), -127, 127)  -> int8 (M, N), f32 (M,).
//
// Bound on the H100: bytes.  K7 reads 2 bytes and writes 1 per element
// (prefill, M 20,480 x K 4096: 252 MB, 75 us at 3.35 TB/s); K10 the same
// plus the scale vector once (the align step's down projection, M 16,384 x
// N 14,336: 705 MB, 210 us).  A few operations per element.
//
// Design: one CTA of 128 threads per row.  Pass 1 reads the row in 16-byte
// vectors (8 bf16) and reduces |x| (K10: |dy * scale|) to the row max (warp
// shuffles, then one value per warp in shared memory).  Pass 2 reads the row
// again (from L1 / L2: a row is at most 28 KB) and writes 8 int8 a thread at
// a time.  The arithmetic is the reference's as XLA compiles it, bit for bit
// (the optimised HLO of both shows it): the scale is the max times
// f32(1/127) (XLA folds the division by the constant into that multiply),
// K10's dy * scale one rounded multiply (__fmul_rn, in both passes),
// x / scale an IEEE division (__fdiv_rn; the build has no --use_fast_math),
// rintf's round half to even, the clamp, then the cast.  K % 8 == 0 and
// 16-byte aligned rows and scale (the wrappers' rule).  K10 writes its rows
// ld_out bytes apart (a multiple of 8): ops/int8_linear.py gives it rows of
// N rounded up to 16, whose 16-byte stride K11's tensor map needs.

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

// the 8 values of vector c of the row, widened to f32 (K10: times their
// column's scale, one rounded multiply each)
template <bool DY>
__device__ __forceinline__ void aq_load8(const uint4* __restrict__ xr, const float4* __restrict__ col_scale, int c,
                                         float (&f)[8]) {
  const uint4 v = xr[c];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
  if constexpr (DY) {
    const float4 s0 = col_scale[2 * c], s1 = col_scale[2 * c + 1];
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __fmul_rn(f[i], s[i]);
  }
}

// DY = false: K7 (x, no column scale, floor 1e-12); DY = true: K10 (dy,
// the weight's scale per column, floor 1e-30)
template <bool DY>
__global__ void __launch_bounds__(AQ_THREADS) act_quant_kernel(const __nv_bfloat16* __restrict__ x,
                                                                const float* __restrict__ col_scale,
                                                                int8_t* __restrict__ xq,
                                                                float* __restrict__ ascale, int K, long long ld_out) {
  __shared__ float warp_max[AQ_THREADS / 32];
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * K);
  const float4* cs = reinterpret_cast<const float4*>(col_scale);
  const int vecs = K / 8;

  float m = 0.0f;
  for (int c = threadIdx.x; c < vecs; c += AQ_THREADS) {
    float f[8];
    aq_load8<DY>(xr, cs, c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(f[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < AQ_THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
  const float s = fmaxf(__fmul_rn(m, 1.0f / 127.0f), DY ? 1e-30f : 1e-12f);
  if (threadIdx.x == 0) ascale[row] = s;

  uint2* qr = reinterpret_cast<uint2*>(xq + row * ld_out);
  for (int c = threadIdx.x; c < vecs; c += AQ_THREADS) {
    float f[8];
    aq_load8<DY>(xr, cs, c, f);
    uint32_t w[2];
#pragma unroll
    for (int half = 0; half < 2; ++half)
      w[half] = static_cast<uint32_t>(static_cast<uint8_t>(aq_quant(f[4 * half], s))) |
                static_cast<uint32_t>(static_cast<uint8_t>(aq_quant(f[4 * half + 1], s))) << 8 |
                static_cast<uint32_t>(static_cast<uint8_t>(aq_quant(f[4 * half + 2], s))) << 16 |
                static_cast<uint32_t>(static_cast<uint8_t>(aq_quant(f[4 * half + 3], s))) << 24;
    qr[c] = make_uint2(w[0], w[1]);
  }
}

}  // namespace srgpt

extern "C" int srgpt_act_quant(const void* x, void* xq, void* ascale, long long M, int K, void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  srgpt::act_quant_kernel<false><<<static_cast<unsigned>(M), srgpt::AQ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), nullptr, static_cast<int8_t*>(xq), static_cast<float*>(ascale), K, K);
  return static_cast<int>(cudaGetLastError());
}

// K10: dy (M, N) bf16 and the weight's scale (N,) f32 -> dyq (M, N) int8 with
// rows ld bytes apart (ld >= N, ld % 8 == 0), gscale (M,) f32
extern "C" int srgpt_act_quant_dy(const void* dy, const void* scale, void* dyq, void* gscale, long long M, int N,
                                  long long ld, void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  if (ld < N || ld % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  srgpt::act_quant_kernel<true><<<static_cast<unsigned>(M), srgpt::AQ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(scale), static_cast<int8_t*>(dyq),
      static_cast<float*>(gscale), N, ld);
  return static_cast<int>(cudaGetLastError());
}

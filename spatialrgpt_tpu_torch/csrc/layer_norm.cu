// K6: one-pass row LayerNorm, bf16 in and out, f32 statistics and affine.
//
// Replaces the Pallas kernel spatialrgpt_tpu/ops/layer_norm.py::fused_layer_norm
// (_kernel).  Per row of C values:
//   mean = sum(x) / C;  var = sum((x - mean)^2) / C   (two passes over the
//   row held in registers, as the reference computes it, not E[x^2] - mean^2)
//   y = bf16((x - mean) * rsqrt(var + eps) * w + b)   (affine in f32, one
//   rounding)
// w and b come in the dtype the model holds them in, bf16 or f32, and are
// widened in registers (bf16 -> f32 is exact), so a call is one launch.
//
// Bound on the H100: device-memory bytes.  At SAM vit_h's 16,384 x 1280
// rows a call reads and writes 84 MB (25 us at 3.35 TB/s) and does ~8 FLOPs
// per element.
//
// Design (C % 8 == 0, 16-byte aligned rows and weights, C <= 2048: every
// caller of the demo path): a streaming kernel.  A grid of as many CTAs of
// 4 warps as fit on the card at once walks the rows, one warp per row and
// a grid-stride between a warp's rows.  Each lane loads its columns of w
// and b once (16-byte loads, kept packed in registers across all its rows)
// and 8 columns of the row per 16-byte load.  A warp issues the loads of its
// next row before it reduces the current one, so two rows per warp are in
// flight; x is read and y written with streaming hints (__ldcs / __stcs),
// since each is touched once.  Other C <= 2048 (or unaligned rows) take one
// element per lane per step, C > 2048 reads the row from memory once per
// pass; both are one warp per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srgpt {

using bf16 = __nv_bfloat16;

constexpr int LN_WARPS = 4;  // warps per CTA (the streaming kernel keeps two rows a warp in flight)
constexpr int LN_THREADS = LN_WARPS * 32;

__device__ __forceinline__ float ln_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// 8 consecutive values held packed, widened to f32 on use
template <typename T>
struct Pack8;

template <>
struct Pack8<bf16> {
  uint4 u;
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void load(const bf16* p) { u = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void load_streaming(const bf16* p) { u = __ldcs(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ float at(int t) const {
    const uint32_t w = t < 2 ? u.x : t < 4 ? u.y : t < 6 ? u.z : u.w;
    return __uint_as_float(t % 2 ? w & 0xffff0000u : w << 16);
  }
};

template <>
struct Pack8<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float at(int t) const {
    const float4& v = t < 4 ? lo : hi;
    const int e = t % 4;
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};

// NCH 16-byte chunks per lane: C <= 256 * NCH.  With bf16 weights 4 CTAs
// per SM (128 registers) up to C = 1024, 3 (170) up to 1536 and 2 above,
// without spills; f32 weights take twice the registers.
template <typename WT, int NCH>
__global__ void __launch_bounds__(LN_THREADS, sizeof(WT) == 2 ? (NCH <= 4 ? 4 : NCH <= 6 ? 3 : 2) : 1)
layer_norm_stream_kernel(const bf16* __restrict__ x, const WT* __restrict__ w, const WT* __restrict__ b,
                         bf16* __restrict__ y, long long rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const long long stride = static_cast<long long>(gridDim.x) * LN_WARPS;
  long long row = static_cast<long long>(blockIdx.x) * LN_WARPS + threadIdx.x / 32;
  if (row >= rows) return;

  Pack8<WT> wv[NCH], bv[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < C) {
      wv[i].load(w + c);
      bv[i].load(b + c);
    }
  }
  Pack8<bf16> cur[NCH], nxt[NCH];
  auto load_row = [&](Pack8<bf16>(&dst)[NCH], long long r) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c < C)
        dst[i].load_streaming(x + r * C + c);
      else
        dst[i].zero();
    }
  };
  load_row(cur, row);

  for (; row < rows; row += stride) {
    if (row + stride < rows) load_row(nxt, row + stride);  // in flight while this row reduces

    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) sum += cur[i].at(t);
    const float mean = ln_warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      if ((lane + 32 * i) * 8 < C) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float d = cur[i].at(t) - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(ln_warp_sum(sq) / C + eps);
    bf16* yr = y + row * C;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = (lane + 32 * i) * 8;
      if (c >= C) continue;
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int t = 0; t < 8; t += 2) {
        const float y0 = (cur[i].at(t) - mean) * rstd * wv[i].at(t) + bv[i].at(t);
        const float y1 = (cur[i].at(t + 1) - mean) * rstd * wv[i].at(t + 1) + bv[i].at(t + 1);
        __nv_bfloat162 pair = __floats2bfloat162_rn(y0, y1);
        o[t / 2] = *reinterpret_cast<uint32_t*>(&pair);
      }
      __stcs(reinterpret_cast<uint4*>(yr + c), out);
    }
#pragma unroll
    for (int i = 0; i < NCH; ++i) cur[i] = nxt[i];
  }
}

// Any C <= 32 * NCH, any alignment: one element per lane per step, the row
// in registers, one warp per row.
template <typename WT, int NCH>
__global__ void __launch_bounds__(LN_WARPS * 32)
layer_norm_scalar_kernel(const bf16* __restrict__ x, const WT* __restrict__ w, const WT* __restrict__ b,
                         bf16* __restrict__ y, long long rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * LN_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const bf16* xr = x + row * C;
  bf16* yr = y + row * C;
  float v[NCH];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? __bfloat162float(xr[c]) : 0.f;
    sum += v[i];
  }
  const float mean = ln_warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    if (lane + 32 * i < C) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(ln_warp_sum(sq) / C + eps);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = lane + 32 * i;
    if (c < C) yr[c] = __float2bfloat16((v[i] - mean) * rstd * to_f32(w[c]) + to_f32(b[c]));
  }
}

// C > 2048: the same arithmetic, the row read from memory once per pass.
template <typename WT>
__global__ void __launch_bounds__(LN_WARPS * 32)
layer_norm_wide_kernel(const bf16* __restrict__ x, const WT* __restrict__ w, const WT* __restrict__ b,
                       bf16* __restrict__ y, long long rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * LN_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const bf16* xr = x + row * C;
  bf16* yr = y + row * C;
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += __bfloat162float(xr[c]);
  const float mean = ln_warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = __bfloat162float(xr[c]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(ln_warp_sum(sq) / C + eps);
  for (int c = lane; c < C; c += 32)
    yr[c] = __float2bfloat16((__bfloat162float(xr[c]) - mean) * rstd * to_f32(w[c]) + to_f32(b[c]));
}

// the streaming grid: as many CTAs as are resident on the card at once (no
// more than the rows need), each warp then striding over the rows
template <typename WT, int NCH>
cudaError_t launch_stream(const bf16* x, const WT* w, const WT* b, bf16* y, long long rows, int C, float eps,
                          cudaStream_t stream) {
  auto kern = layer_norm_stream_kernel<WT, NCH>;
  static int resident = 0;  // CTAs the card holds at once (the card of the first call)
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, LN_THREADS, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (rows + LN_WARPS - 1) / LN_WARPS;
  const unsigned blocks = static_cast<unsigned>(need < resident ? need : resident);
  kern<<<blocks, LN_THREADS, 0, stream>>>(x, w, b, y, rows, C, eps);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_any(const bf16* x, const WT* w, const WT* b, bf16* y, long long rows, int C, float eps,
                       bool vec, cudaStream_t s) {
  if (vec && C <= 2048) {
    switch ((C + 255) / 256) {  // 16-byte chunks per lane
      case 1: return launch_stream<WT, 1>(x, w, b, y, rows, C, eps, s);
      case 2: return launch_stream<WT, 2>(x, w, b, y, rows, C, eps, s);
      case 3: return launch_stream<WT, 3>(x, w, b, y, rows, C, eps, s);
      case 4: return launch_stream<WT, 4>(x, w, b, y, rows, C, eps, s);
      case 5: return launch_stream<WT, 5>(x, w, b, y, rows, C, eps, s);
      case 6: return launch_stream<WT, 6>(x, w, b, y, rows, C, eps, s);
      case 7: return launch_stream<WT, 7>(x, w, b, y, rows, C, eps, s);
      default: return launch_stream<WT, 8>(x, w, b, y, rows, C, eps, s);
    }
  }
  const unsigned blocks = static_cast<unsigned>((rows + LN_WARPS - 1) / LN_WARPS);
  if (C <= 128)
    layer_norm_scalar_kernel<WT, 4><<<blocks, LN_WARPS * 32, 0, s>>>(x, w, b, y, rows, C, eps);
  else if (C <= 512)
    layer_norm_scalar_kernel<WT, 16><<<blocks, LN_WARPS * 32, 0, s>>>(x, w, b, y, rows, C, eps);
  else if (C <= 2048)
    layer_norm_scalar_kernel<WT, 64><<<blocks, LN_WARPS * 32, 0, s>>>(x, w, b, y, rows, C, eps);
  else
    layer_norm_wide_kernel<WT><<<blocks, LN_WARPS * 32, 0, s>>>(x, w, b, y, rows, C, eps);
  return cudaGetLastError();
}

}  // namespace srgpt

// w and b: bf16 (weight_f32 == 0) or f32 (weight_f32 != 0), both the same
extern "C" int srgpt_layer_norm(const void* x, const void* w, const void* b, void* y, long long rows, int C,
                                float eps, int weight_f32, void* stream) {
  using namespace srgpt;
  if (rows <= 0 || C <= 0 || (rows + LN_WARPS - 1) / LN_WARPS > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = C % 8 == 0 && aligned(x) && aligned(y) && aligned(w) && aligned(b);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = weight_f32 ? launch_any(xp, static_cast<const float*>(w), static_cast<const float*>(b), yp, rows,
                                            C, eps, vec, s)
                               : launch_any(xp, static_cast<const bf16*>(w), static_cast<const bf16*>(b), yp, rows,
                                            C, eps, vec, s);
  return static_cast<int>(err);
}

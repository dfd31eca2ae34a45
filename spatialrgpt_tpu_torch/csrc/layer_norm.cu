// K6: one-pass row LayerNorm, bf16 in and out, f32 statistics and affine.
//
// Replaces the Pallas kernel spatialrgpt_tpu/ops/layer_norm.py::fused_layer_norm
// (_kernel).  Per row of C values:
//   mean = sum(x) / C;  var = sum((x - mean)^2) / C   (two passes over the
//   row held in registers, as the reference computes it, not E[x^2] - mean^2)
//   y = bf16((x - mean) * rsqrt(var + eps) * w + b)   (affine in f32, one
//   rounding)
//
// Bound on the H100: device-memory bytes.  At SAM vit_h's 16,384 x 1280
// rows a call reads and writes 84 MB (25 us at 3.35 TB/s) and does ~8 FLOPs
// per element.
//
// Design: one warp per row, 4 rows per CTA; any row count.  For C % 8 == 0
// (every caller of the demo path) each lane loads 16 bytes (8 bf16) per
// step, so a warp reads 512 contiguous bytes, and the row stays in
// registers (C <= 2048: at most 8 chunks of 8 per lane).  Other C <= 2048
// load one element per lane per step.  C > 2048 re-reads the row from
// memory for each pass.  w and b are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srgpt {

using bf16 = __nv_bfloat16;

constexpr int LN_WARPS = 4;

__device__ __forceinline__ float ln_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// VEC elements per lane per step (8: one 16-byte load; 1: one element), NCH
// steps: the row must satisfy C <= 32 * VEC * NCH.
template <int VEC, int NCH>
__global__ void __launch_bounds__(LN_WARPS * 32)
layer_norm_reg_kernel(const bf16* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
                      bf16* __restrict__ y, long long rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * LN_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const bf16* xr = x + row * C;
  bf16* yr = y + row * C;
  float v[NCH * VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = (lane + 32 * i) * VEC;
    if constexpr (VEC == 8) {
      if (c < C) {
        uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int t = 0; t < 8; ++t) v[i * 8 + t] = __bfloat162float(e[t]);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) v[i * 8 + t] = 0.f;
      }
    } else {
      v[i] = c < C ? __bfloat162float(xr[c]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < VEC; ++t) sum += v[i * VEC + t];
  }
  const float mean = ln_warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = (lane + 32 * i) * VEC;
    if (c < C) {
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        const float d = v[i * VEC + t] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(ln_warp_sum(sq) / C + eps);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = (lane + 32 * i) * VEC;
    if (c >= C) continue;
    if constexpr (VEC == 8) {
      __align__(16) bf16 out[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) out[t] = __float2bfloat16((v[i * 8 + t] - mean) * rstd * w[c + t] + b[c + t]);
      *reinterpret_cast<uint4*>(yr + c) = *reinterpret_cast<const uint4*>(out);
    } else {
      yr[c] = __float2bfloat16((v[i] - mean) * rstd * w[c] + b[c]);
    }
  }
}

// C > 2048: the same arithmetic, the row read from memory once per pass.
__global__ void __launch_bounds__(LN_WARPS * 32)
layer_norm_wide_kernel(const bf16* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
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
  for (int c = lane; c < C; c += 32) yr[c] = __float2bfloat16((__bfloat162float(xr[c]) - mean) * rstd * w[c] + b[c]);
}

template <int VEC, int NCH>
cudaError_t launch_reg(const bf16* x, const float* w, const float* b, bf16* y, long long rows, int C, float eps,
                       cudaStream_t stream) {
  const long long blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  layer_norm_reg_kernel<VEC, NCH><<<static_cast<unsigned>(blocks), LN_WARPS * 32, 0, stream>>>(x, w, b, y, rows, C, eps);
  return cudaGetLastError();
}

}  // namespace srgpt

extern "C" int srgpt_layer_norm(const void* x, const void* w, const void* b, void* y, long long rows, int C,
                                float eps, void* stream) {
  using namespace srgpt;
  if (rows <= 0 || C <= 0 || (rows + LN_WARPS - 1) / LN_WARPS > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* xp = static_cast<const bf16*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaError_t err;
  if (vec && C <= 2048) {
    switch ((C + 255) / 256) {  // 16-byte chunks per lane
      case 1: err = launch_reg<8, 1>(xp, wp, bp, yp, rows, C, eps, s); break;
      case 2: err = launch_reg<8, 2>(xp, wp, bp, yp, rows, C, eps, s); break;
      case 3: err = launch_reg<8, 3>(xp, wp, bp, yp, rows, C, eps, s); break;
      case 4: err = launch_reg<8, 4>(xp, wp, bp, yp, rows, C, eps, s); break;
      case 5: err = launch_reg<8, 5>(xp, wp, bp, yp, rows, C, eps, s); break;
      case 6: err = launch_reg<8, 6>(xp, wp, bp, yp, rows, C, eps, s); break;
      case 7: err = launch_reg<8, 7>(xp, wp, bp, yp, rows, C, eps, s); break;
      default: err = launch_reg<8, 8>(xp, wp, bp, yp, rows, C, eps, s); break;
    }
  } else if (C <= 128) {
    err = launch_reg<1, 4>(xp, wp, bp, yp, rows, C, eps, s);
  } else if (C <= 512) {
    err = launch_reg<1, 16>(xp, wp, bp, yp, rows, C, eps, s);
  } else if (C <= 2048) {
    err = launch_reg<1, 64>(xp, wp, bp, yp, rows, C, eps, s);
  } else {
    const long long blocks = (rows + LN_WARPS - 1) / LN_WARPS;
    layer_norm_wide_kernel<<<static_cast<unsigned>(blocks), LN_WARPS * 32, 0, s>>>(xp, wp, bp, yp, rows, C, eps);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

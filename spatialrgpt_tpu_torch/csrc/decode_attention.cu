// K3: one-token decode attention against the flat token-major int8 KV cache.
//
// Replaces the Pallas kernel
// spatialrgpt_tpu/ops/decode_attention.py::decode_attention_int8_flat (_decode_kernel).
//
// Bound on the H100: bytes of the int8 cache.  Per step and layer every
// live cache position is read once (2 * Hk * D int8 bytes + 2 * Hk fp32
// scales) for ~4 FLOPs per byte -- far below the ~295 FLOP/byte ridge, so
// the kernel's job is to stream the cache at full bandwidth with enough
// CTAs in flight (B = 8, C = 352, Hk = 8, D = 128: at most 5.9 MB, 1.8 us
// at 3.35 TB/s).
//
// Design: flash-decoding.  Pass 1 splits the cache length C into chunks of
// 64 positions and runs one CTA per (chunk, kv head, batch row); the CTA
// serves the n_rep query heads of its kv head, so the cache is read once at
// kv-head width.  Positions > lengths[b] are never read.  Each warp takes
// whole positions: a lane loads 4 int8 of the key row (coalesced 128-byte
// rows), dequantizes in registers, and a shuffle reduction gives the dot;
// the K scale multiplies the score.  The chunk's softmax partials (max,
// sum, unnormalised P V with the V scale folded into P, all fp32) go to a
// small scratch.  Pass 2 combines the partials per (b, query head).  The
// block-diagonal Q and the (F, Hq) accumulator of the Pallas kernel were
// workarounds for the TPU's matrix unit and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace srgpt {

using bf16 = __nv_bfloat16;

constexpr int DEC_CHUNK = 64;     // cache positions per CTA
constexpr int DEC_THREADS = 128;  // 4 warps
constexpr int DEC_MAXREP = 8;     // query heads per kv head
constexpr int DEC_MAXD = 256;     // head dim

__device__ __forceinline__ float dec_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dec_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// grid (nsplit, Hk, B)
__global__ void __launch_bounds__(DEC_THREADS)
decode_split_kernel(const bf16* __restrict__ q,       // (B, Hq, D)
                    const int8_t* __restrict__ kq,    // (B, C, Hk * D)
                    const float* __restrict__ ks,     // (B, C, Hk)
                    const int8_t* __restrict__ vq,    // (B, C, Hk * D)
                    const float* __restrict__ vs,     // (B, C, Hk)
                    const int* __restrict__ lengths,  // (B,)
                    float* __restrict__ part_m,       // (B, Hq, nsplit)
                    float* __restrict__ part_l,       // (B, Hq, nsplit)
                    float* __restrict__ part_acc,     // (B, Hq, nsplit, D)
                    int C, int Hk, int D, int n_rep, float sm_scale) {
  __shared__ float sq[DEC_MAXREP][DEC_MAXD];
  __shared__ float sp[DEC_MAXREP][DEC_CHUNK];  // scores, then p * v_scale
  __shared__ float sm[DEC_MAXREP];
  __shared__ float sl[DEC_MAXREP];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int Hq = Hk * n_rep;
  const int F = Hk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = split * DEC_CHUNK;
  int c_end = lengths[b] + 1;  // live positions are <= lengths[b]
  if (c_end > C) c_end = C;
  if (c_end > c0 + DEC_CHUNK) c_end = c0 + DEC_CHUNK;
  const int n = c_end - c0;

  if (n <= 0) {  // chunk wholly past the row's length
    for (int g = 0; g < n_rep; ++g) {
      const long long pi = ((long long)b * Hq + h * n_rep + g) * nsplit + split;
      if (threadIdx.x == 0) {
        part_m[pi] = -INFINITY;
        part_l[pi] = 0.f;
      }
      for (int d = threadIdx.x; d < D; d += DEC_THREADS) part_acc[pi * D + d] = 0.f;
    }
    return;
  }

  for (int idx = threadIdx.x; idx < n_rep * D; idx += DEC_THREADS) {
    const int g = idx / D, d = idx % D;
    sq[g][d] = __bfloat162float(q[((long long)b * Hq + h * n_rep + g) * D + d]);
  }
  __syncthreads();

  // ---- scores: one warp per position, a lane per 4 bytes of the key row ----
  for (int c = warp; c < n; c += DEC_THREADS / 32) {
    const long long pos = (long long)b * C + c0 + c;
    const int8_t* krow = kq + pos * F + h * D;
    float dot[DEC_MAXREP];
#pragma unroll
    for (int g = 0; g < DEC_MAXREP; ++g) dot[g] = 0.f;
    for (int d = lane * 4; d < D; d += 128) {
      const char4 kv4 = *reinterpret_cast<const char4*>(krow + d);
      const float k0 = kv4.x, k1 = kv4.y, k2 = kv4.z, k3 = kv4.w;
#pragma unroll
      for (int g = 0; g < DEC_MAXREP; ++g) {
        if (g < n_rep) dot[g] += sq[g][d] * k0 + sq[g][d + 1] * k1 + sq[g][d + 2] * k2 + sq[g][d + 3] * k3;
      }
    }
    const float kscale = ks[pos * Hk + h] * sm_scale;
#pragma unroll
    for (int g = 0; g < DEC_MAXREP; ++g) {
      if (g < n_rep) {
        const float s = dec_warp_sum(dot[g]);
        if (lane == 0) sp[g][c] = s * kscale;
      }
    }
  }
  __syncthreads();

  // ---- chunk softmax partials: one warp per query head ----
  for (int g = warp; g < n_rep; g += DEC_THREADS / 32) {
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, sp[g][c]);
    m = dec_warp_max(m);
    float l = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float p = expf(sp[g][c] - m);
      l += p;
      sp[g][c] = p * vs[((long long)b * C + c0 + c) * Hk + h];  // fold V scale into P
    }
    l = dec_warp_sum(l);
    if (lane == 0) {
      sm[g] = m;
      sl[g] = l;
    }
  }
  __syncthreads();

  // ---- unnormalised P V: a thread per head-dim element ----
  for (int d = threadIdx.x; d < D; d += DEC_THREADS) {
    float acc[DEC_MAXREP];
#pragma unroll
    for (int g = 0; g < DEC_MAXREP; ++g) acc[g] = 0.f;
    const int8_t* vcol = vq + ((long long)b * C + c0) * F + h * D + d;
    for (int c = 0; c < n; ++c) {
      const float val = vcol[(long long)c * F];
#pragma unroll
      for (int g = 0; g < DEC_MAXREP; ++g) {
        if (g < n_rep) acc[g] += sp[g][c] * val;
      }
    }
#pragma unroll
    for (int g = 0; g < DEC_MAXREP; ++g) {
      if (g < n_rep) {
        const long long pi = ((long long)b * Hq + h * n_rep + g) * nsplit + split;
        part_acc[pi * D + d] = acc[g];
      }
    }
  }
  if (threadIdx.x < n_rep) {
    const int g = threadIdx.x;
    const long long pi = ((long long)b * Hq + h * n_rep + g) * nsplit + split;
    part_m[pi] = sm[g];
    part_l[pi] = sl[g];
  }
}

// grid (Hq, B): out[b, hq, :] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s
__global__ void __launch_bounds__(DEC_THREADS)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, bf16* __restrict__ out,
                      int nsplit, int D) {
  const int hq = blockIdx.x, b = blockIdx.y, Hq = gridDim.x;
  const long long base = ((long long)b * Hq + hq) * nsplit;
  float M = -INFINITY;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_m[base + s]);
  float L = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    if (part_m[base + s] != -INFINITY) L += expf(part_m[base + s] - M) * part_l[base + s];
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  for (int d = threadIdx.x; d < D; d += DEC_THREADS) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      if (part_m[base + s] != -INFINITY) acc += expf(part_m[base + s] - M) * part_acc[(base + s) * D + d];
    }
    out[((long long)b * Hq + hq) * D + d] = __float2bfloat16(acc * inv);
  }
}

}  // namespace srgpt

extern "C" int srgpt_decode_num_splits(int C) {
  return (C + srgpt::DEC_CHUNK - 1) / srgpt::DEC_CHUNK;
}

extern "C" int srgpt_decode_attention(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* lengths, void* part_m, void* part_l, void* part_acc, void* out,
    int B, int C, int Hq, int Hk, int D, float sm_scale, void* stream) {
  using namespace srgpt;
  if (Hk <= 0 || Hq % Hk != 0 || Hq / Hk > DEC_MAXREP || D % 4 != 0 || D > DEC_MAXD || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsplit = srgpt_decode_num_splits(C);
  decode_split_kernel<<<dim3(nsplit, Hk, B), DEC_THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
      C, Hk, D, Hq / Hk, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<dim3(Hq, B), DEC_THREADS, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<bf16*>(out), nsplit, D);
  return static_cast<int>(cudaGetLastError());
}

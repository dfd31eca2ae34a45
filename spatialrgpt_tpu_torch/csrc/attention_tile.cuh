// WMMA tiles of K4's dK/dV kernel (flash_attention.cu): 64-row bf16 tiles
// with the head dim zero-padded to DP (a multiple of 16) in shared memory
// only, read from device memory at its true width through the caller's
// (B, S, H, D) strides.  The other attention kernels (K1, K2, K4's forward
// and dQ, K5) run on the Hopper main loop of attention_sm90.cuh; this file
// goes when dK/dV moves there too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace srgpt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int NWARPS = 4;     // BM / 16
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = BN + 4;   // fp32 score row stride
constexpr int LDP = BN + 8;   // bf16 probability row stride

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

struct Strides {
  long long b, s, h;  // element strides of a (B, S, H, D) tensor; d-stride is 1
};

// Copy `rows` rows of D bf16 (D % 8 == 0) into a DP-wide smem tile of row
// stride DP + 8, 16 bytes per thread per step; rows where row_src returns
// nullptr and columns >= D are zero-filled.
template <int DP, typename RowSrc>
__device__ __forceinline__ void load_tile(bf16* dst, int rows, int D, RowSrc row_src) {
  constexpr int LDQ = DP + 8;  // skews banks
  constexpr int CH = DP / 8;  // 16-byte chunks per padded row
  for (int idx = threadIdx.x; idx < rows * CH; idx += NTHREADS) {
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    const bf16* src = row_src(r);
    if (src != nullptr && c < D) val = *reinterpret_cast<const uint4*>(src + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = val;
  }
}

}  // namespace srgpt

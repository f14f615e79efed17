// K3 and K4: additive-NTT butterfly stages on bit planes.
//
// K3 replaces `_local_kernel` (binius_tpu/ntt/bitsliced_ntt.py, launched by
// `_pallas_local`): every stage whose pair distance fits one tile, fused.
// K4 replaces `_pair_kernel` (launched by `_pallas_pair`): one stage whose
// word distance is too large for a tile.
//
// Data are bit planes [P, W] (plane b holds bit b of 32 consecutive
// elements per word). A forward butterfly is u ^= t*v; v ^= u, the inverse
// v ^= u; u ^= t*v. The twiddle t lies in B32 and the data in B32 or above:
// multiplication by a B32 scalar acts on each group of 32 planes on its
// own, and the XORs are plane-wise, so a B128 transform over B32 twiddles is
// four independent B32 transforms on plane groups [32g, 32g + 32). The
// group is a grid dimension. Per word the twiddle arrives packed (one
// uint32 per word and stage); its bits become all-0 / all-1 masks, XORed
// with the stage's intra-word delta masks where the pair distance is below
// 32 elements, and the B32 Karatsuba network `_mul_bs(5, masks, x)` runs on
// 32 data planes and 32 mask planes held by one thread.
//
// Bound on the H100: per word pair, group and stage the network costs about
// 1,550 32-bit operations (1,388 gates of the B32 Karatsuba network, the
// mask expansion and the butterfly XORs), while a stage that passes through
// HBM moves 8 bytes per word of each plane. K3 keeps a 1024-word tile of one
// group (32 planes x 4 KB = 128 KB) in shared memory and runs all of its
// stages there, so they cost one HBM read and one write together and the
// operations bound it; K4 is one HBM pass per stage, each thread owning one
// (u, v) word pair of one group, and the bytes bound it.

#include <cstdint>
#include <cuda_runtime.h>

#include "tower_bs.cuh"

namespace {

using tower_bs::Bs;

__device__ __forceinline__ void word_masks(uint32_t tw, const int* deltas,
                                           uint32_t* m) {
#pragma unroll
  for (int b = 0; b < 32; ++b)
    m[b] = (0u - ((tw >> b) & 1u)) ^ (uint32_t)deltas[b];
}

// bits p of a word whose element sits in the u half: (p / d) even
__device__ __forceinline__ uint32_t intra_mask_u(int d) {
  switch (d) {
    case 16: return 0x0000FFFFu;
    case 8: return 0x00FF00FFu;
    case 4: return 0x0F0F0F0Fu;
    case 2: return 0x33333333u;
    default: return 0x55555555u;
  }
}

// One word's butterflies at element distance d < 32 (_butterfly_intra).
// x is the word's plane column with stride `stride`.
template <bool INV>
__device__ __forceinline__ void butterfly_intra(uint32_t* x, int stride,
                                                uint32_t tw,
                                                const int* deltas, int d) {
  uint32_t m[32], v[32], sc[32];
  const uint32_t mu = intra_mask_u(d), mv = ~mu;
  word_masks(tw, deltas, m);
  if (!INV) {
#pragma unroll
    for (int b = 0; b < 32; ++b) v[b] = x[b * stride];
    Bs<5>::mul(m, v, sc);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      uint32_t xu = v[b] ^ ((sc[b] & mv) >> d);
      uint32_t xv = v[b] ^ ((xu & mu) << d);
      x[b * stride] = (xu & mu) | (xv & mv);
    }
  } else {
    uint32_t xv[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      uint32_t xb = x[b * stride];
      xv[b] = xb ^ ((xb & mu) << d);
      v[b] = (xb & mu) | (xv[b] & mv);
    }
    Bs<5>::mul(m, v, sc);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      uint32_t xu = x[b * stride] ^ ((sc[b] & mv) >> d);
      x[b * stride] = (xu & mu) | (xv[b] & mv);
    }
  }
}

__device__ __constant__ int kZeroDeltas[32] = {0};

// One (u, v) word pair of one group; plane b of u at u[b * stride].
template <bool INV>
__device__ __forceinline__ void butterfly_pair(uint32_t* u, uint32_t* v,
                                               long long stride, uint32_t tw) {
  uint32_t m[32], x[32], sc[32];
  word_masks(tw, kZeroDeltas, m);
  if (!INV) {
#pragma unroll
    for (int b = 0; b < 32; ++b) x[b] = v[b * stride];
    Bs<5>::mul(m, x, sc);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      uint32_t nu = u[b * stride] ^ sc[b];
      u[b * stride] = nu;
      v[b * stride] = x[b] ^ nu;
    }
  } else {
#pragma unroll
    for (int b = 0; b < 32; ++b) x[b] = v[b * stride] ^ u[b * stride];
    Bs<5>::mul(m, x, sc);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      u[b * stride] ^= sc[b];
      v[b * stride] = x[b];
    }
  }
}

constexpr int kThreads = 256;
constexpr int kMaxLocalStages = 32;

// K3. Grid (n_words / tile, groups). meta[s] = {d_elems, 32 delta masks}.
template <bool INV>
__global__ void __launch_bounds__(kThreads)
    ntt_local_kernel(uint32_t* __restrict__ planes,
                     const uint32_t* __restrict__ tw,
                     const int* __restrict__ meta, int n_stages, int n_words,
                     int tile) {
  extern __shared__ uint32_t sm[];  // [32][tile]
  __shared__ int s_meta[kMaxLocalStages * 33];
  const long long t0 = (long long)blockIdx.x * tile;
  uint32_t* base = planes + (long long)blockIdx.y * 32 * n_words + t0;
  for (int i = threadIdx.x; i < 32 * tile; i += blockDim.x) {
    int p = i / tile, w = i % tile;
    sm[i] = base[(long long)p * n_words + w];
  }
  for (int i = threadIdx.x; i < n_stages * 33; i += blockDim.x)
    s_meta[i] = meta[i];
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const int d = s_meta[s * 33];
    const int* deltas = s_meta + s * 33 + 1;
    const uint32_t* twr = tw + (long long)s * n_words + t0;
    if (d < 32) {
      for (int w = threadIdx.x; w < tile; w += blockDim.x)
        butterfly_intra<INV>(sm + w, tile, twr[w], deltas, d);
    } else {
      const int dw = d >> 5;
      for (int k = threadIdx.x; k < tile / 2; k += blockDim.x) {
        int wu = (k / dw) * 2 * dw + (k % dw);
        butterfly_pair<INV>(sm + wu, sm + wu + dw, tile, twr[wu]);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 32 * tile; i += blockDim.x) {
    int p = i / tile, w = i % tile;
    base[(long long)p * n_words + w] = sm[i];
  }
}

// K4. Grid (ceil(n_words / 2 / threads), groups); one thread per word pair.
template <bool INV>
__global__ void __launch_bounds__(kThreads)
    ntt_pair_kernel(uint32_t* __restrict__ planes,
                    const uint32_t* __restrict__ tw, int n_words, int dw) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_words / 2) return;
  const long long wu = (k / dw) * 2 * dw + (k % dw);
  uint32_t* base = planes + (long long)blockIdx.y * 32 * n_words;
  butterfly_pair<INV>(base + wu, base + wu + dw, n_words, tw[wu]);
}

}  // namespace

extern "C" int k3_ntt_local(void* planes, const void* tw, const void* meta,
                            int n_stages, int n_words, int groups, int tile,
                            int inverse, void* stream) {
  if (n_stages < 1 || n_stages > kMaxLocalStages || tile < 1 ||
      n_words % tile)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)32 * tile * sizeof(uint32_t);
  dim3 grid(n_words / tile, groups);
  if (inverse) {
    cudaFuncSetAttribute(ntt_local_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    ntt_local_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (uint32_t*)planes, (const uint32_t*)tw, (const int*)meta, n_stages,
        n_words, tile);
  } else {
    cudaFuncSetAttribute(ntt_local_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    ntt_local_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (uint32_t*)planes, (const uint32_t*)tw, (const int*)meta, n_stages,
        n_words, tile);
  }
  return (int)cudaGetLastError();
}

extern "C" int k4_ntt_pair(void* planes, const void* tw, int n_words,
                           int groups, int dw, int inverse, void* stream) {
  if (dw < 1 || n_words % (2 * dw)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n_words / 2 + kThreads - 1) / kThreads), groups);
  if (inverse)
    ntt_pair_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)planes, (const uint32_t*)tw, n_words, dw);
  else
    ntt_pair_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)planes, (const uint32_t*)tw, n_words, dw);
  return (int)cudaGetLastError();
}

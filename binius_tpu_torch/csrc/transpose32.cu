// K2: packed elements <-> bit planes, the relayout around the bitsliced NTT.
//
// Replaces `_transpose32_kernel` (binius_tpu/fields/bitslice_pallas.py),
// launched by `transpose32` inside `to_bitsliced` / `from_bitsliced`: the
// five masked-shift rounds (Hacker's Delight 7-3) that turn 32 packed words
// into 32 bit planes and back, with the (N, limbs) <-> [limbs, 32, N/32]
// relayout folded into the loads and stores.
//
// Data: packed (N, limbs) uint32, limbs 1, 2 or 4; planes [32 * limbs, W]
// with W = N / 32, plane 32g + b holding bit b of limb g of 32 consecutive
// elements, one word per 32 elements.
//
// Bound on the H100: memory. Each word is read once and written once, so
// the floor is 2 x bytes / 3.35 TB/s; the 15 two-input gates per word of
// the transpose are far below it.
//
// Design: coalesced on both sides. A block takes a tile of kTile
// consecutive word columns for all limbs. On the packed side a warp takes
// one column at a time: lane i reads or writes element 32w + i with one
// 4/8/16-byte access, so the warp touches 32 * 4 * limbs contiguous bytes,
// and the warp transpose of bs_transpose.cuh turns its 32 rows into 32
// plane words (or back), for all of the warp's columns round by round. On
// the plane side the tile goes through shared memory, and each warp reads
// or writes 32 consecutive words of one plane. The tile's plane stride in
// shared memory is kTile + 1 words, so both the column writes (32 planes
// of one column) and the row reads (32 columns of one plane) fall in 32
// distinct banks.

#include <cstdint>
#include <cuda_runtime.h>

#include "bs_transpose.cuh"

namespace {

using bs_transpose::load_elem;
using bs_transpose::store_elem;
using bs_transpose::WarpTranspose;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;             // word columns per block
constexpr int kS = kTile + 1;         // plane stride in shared memory
constexpr int kPer = kTile / kWarps;  // columns per warp

template <int LIMBS, bool TO_PLANES>
__global__ void __launch_bounds__(kThreads)
    relayout_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                    long long W) {
  constexpr int NB = 32 * LIMBS;
  __shared__ uint32_t sm[NB * kS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long w0 = (long long)blockIdx.x * kTile;
  const WarpTranspose tr;

  uint32_t v[kPer * LIMBS];  // column warp + i * kWarps, limb g at v[i * LIMBS + g]
  if constexpr (TO_PLANES) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long w = w0 + warp + i * kWarps;
      if (w < W) {
        load_elem<LIMBS>(src + (w * 32 + lane) * LIMBS, v + i * LIMBS);
      } else {
#pragma unroll
        for (int g = 0; g < LIMBS; ++g) v[i * LIMBS + g] = 0u;
      }
    }
    tr.apply<kPer * LIMBS>(v);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int col = warp + i * kWarps;
#pragma unroll
      for (int g = 0; g < LIMBS; ++g) sm[(32 * g + lane) * kS + col] = v[i * LIMBS + g];
    }
    __syncthreads();
#pragma unroll 8
    for (int idx = threadIdx.x; idx < NB * kTile; idx += kThreads) {
      const int q = idx / kTile, col = idx % kTile;
      if (w0 + col < W) dst[q * W + w0 + col] = sm[q * kS + col];
    }
  } else {
#pragma unroll 8
    for (int idx = threadIdx.x; idx < NB * kTile; idx += kThreads) {
      const int q = idx / kTile, col = idx % kTile;
      if (w0 + col < W) sm[q * kS + col] = src[q * W + w0 + col];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int col = warp + i * kWarps;
#pragma unroll
      for (int g = 0; g < LIMBS; ++g) v[i * LIMBS + g] = sm[(32 * g + lane) * kS + col];
    }
    tr.apply<kPer * LIMBS>(v);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long w = w0 + warp + i * kWarps;
      if (w < W) store_elem<LIMBS>(dst + (w * 32 + lane) * LIMBS, v + i * LIMBS);
    }
  }
}

template <int LIMBS>
void launch(const uint32_t* src, uint32_t* dst, long long W, int to_planes,
            cudaStream_t s) {
  const unsigned blocks = (unsigned)((W + kTile - 1) / kTile);
  if (to_planes)
    relayout_kernel<LIMBS, true><<<blocks, kThreads, 0, s>>>(src, dst, W);
  else
    relayout_kernel<LIMBS, false><<<blocks, kThreads, 0, s>>>(src, dst, W);
}

}  // namespace

// to_planes = 1: src packed (32 * n_words, limbs) -> dst planes
// [32 * limbs, n_words]; to_planes = 0: the inverse.
extern "C" int k2_transpose32(const void* src, void* dst, int limbs,
                              long long n_words, int to_planes, void* stream) {
  if (n_words < 1) return (int)cudaErrorInvalidValue;
  const auto* s = (const uint32_t*)src;
  auto* d = (uint32_t*)dst;
  cudaStream_t st = (cudaStream_t)stream;
  if (limbs == 1) {
    launch<1>(s, d, n_words, to_planes, st);
  } else if (limbs == 2) {
    launch<2>(s, d, n_words, to_planes, st);
  } else if (limbs == 4) {
    launch<4>(s, d, n_words, to_planes, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2: bit transpose of every 32x32 block of uint32 words.
//
// Replaces `_transpose32_kernel` (binius_tpu/fields/bitslice_pallas.py),
// launched by `transpose32`: five masked-shift rounds (Hacker's Delight 7-3)
// that turn 32 packed words into 32 bit planes and back.
//
// Bound on the H100: memory. Each 32x32 block is read once and written once
// (2 x 128 B for 32 words of work), so the floor is 2 x bytes / 3.35 TB/s.
// Design: one thread per (group g, column w) keeps its 32 words in
// registers and runs the rounds there; neighbouring threads take
// neighbouring columns. The kernel takes element strides for source and
// destination, so the (N, limbs) <-> [limbs, 32, N/32] relayout around the
// NTT is folded into its indexing and never materialised.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void transpose32_kernel(const uint32_t* __restrict__ src,
                                   uint32_t* __restrict__ dst, int groups,
                                   int n_words, long long sg, long long sj,
                                   long long sw, long long dg, long long db,
                                   long long dw) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)groups * n_words) return;
  long long g = idx / n_words;
  long long w = idx % n_words;
  const uint32_t* s = src + g * sg + w * sw;
  uint32_t x[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) x[j] = s[j * sj];
  const uint32_t keep[5] = {0xFFFF0000u, 0xFF00FF00u, 0xF0F0F0F0u,
                            0xCCCCCCCCu, 0xAAAAAAAAu};
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const int j = 16 >> r;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k & j) continue;
      uint32_t t = (x[k] ^ (x[k + j] << j)) & keep[r];
      x[k] ^= t;
      x[k + j] ^= t >> j;
    }
  }
  uint32_t* d = dst + g * dg + w * dw;
#pragma unroll
  for (int b = 0; b < 32; ++b) d[b * db] = x[b];
}

}  // namespace

extern "C" int k2_transpose32(const void* src, void* dst, int groups,
                              int n_words, long long sg, long long sj,
                              long long sw, long long dg, long long db,
                              long long dw, void* stream) {
  const int threads = 256;
  long long total = (long long)groups * n_words;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  transpose32_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)src, (uint32_t*)dst, groups, n_words, sg, sj, sw, dg,
      db, dw);
  return (int)cudaGetLastError();
}

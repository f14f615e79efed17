// K3 and K4: additive-NTT butterfly stages on bit planes.
//
// K3 replaces `_local_kernel` (binius_tpu/ntt/bitsliced_ntt.py, launched by
// `_pallas_local`): every stage whose pair distance fits one tile, fused.
// K4 replaces `_pair_kernel` (launched by `_pallas_pair`): a stage whose
// word distance is too large for a tile (a cross stage).
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
// HBM moves 8 bytes per word of each plane. So every kernel here keeps a
// tile of one group in shared memory, runs several stages on it and passes
// through HBM once: the operations bound them.
//  * K3 holds 1024 consecutive words of 32 planes (128 KB) and runs every
//    stage whose pair distance lies inside it. The tile and the stages'
//    twiddle rows for it (11 x 4 KB at the 2^22-row commit) come in by
//    16-byte cp.async, so a block keeps all of its tile's loads in flight
//    at once, and go out by 16-byte stores; passing them through registers
//    4 bytes at a time had cost more than half the kernel's time (0.62 of
//    1.17 ms at the commit's shape, scripts/k3_stages.py). An intra-word
//    stage (pair distance d < 32 elements) scales only the v half of each
//    word, so one network serves two words: their v halves packed into one
//    word (the first word's shifted into the u positions, the second's in
//    place), the twiddle masks packed alike; the network works lane by
//    lane, so the packed product is both words' products (512 networks a
//    tile, not 1024).
//  * K4 runs a run of up to 7 consecutive cross stages, at word distances
//    2^lo_bit ... 2^(lo_bit + s - 1). Those stages pair words that differ
//    only in index bits lo_bit .. lo_bit + s - 1, so for fixed other bits
//    the 2^s words they touch form a closed set. A block takes, for one
//    group, one value of the bits above and 2^(10 - s) consecutive values
//    of the bits below (8 at s = 7: a 32-byte sector per plane row), the
//    32 x 1024 words (128 KB, a strided 3-D box, copied in with cp.async),
//    runs the s stages there and writes back once. The caller groups a plan's
//    cross stages into runs (bitsliced_ntt._cross_runs): the 2^22-row
//    commit's 7 cross stages are one launch, one HBM pass.

#include <cstdint>
#include <cuda_runtime.h>

#include "tower_bs.cuh"

namespace {

using tower_bs::Bs;

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

// The butterflies at element distance d < 32 of two words x0 and x1
// (_butterfly_intra on each), one network for both: the v halves packed
// into one word, x0's shifted down into the u positions and x1's in place,
// and their twiddle masks alike. `dm` holds the stage's delta masks packed
// that way (pack_deltas). x0 and x1 are plane columns with stride `stride`,
// read again after the network so that no second array stays live.
template <bool INV>
__device__ __forceinline__ void butterfly_intra_packed(uint32_t* x0, uint32_t* x1, int stride,
                                                       uint32_t tw0, uint32_t tw1,
                                                       const uint32_t* dm, int d) {
  uint32_t m[32], v[32], sc[32];
  const uint32_t mu = intra_mask_u(d), mv = ~mu;
#pragma unroll
  for (int b = 0; b < 32; ++b)
    m[b] = dm[b] ^ (((0u - ((tw0 >> b) & 1u)) & mu) | ((0u - ((tw1 >> b) & 1u)) & mv));
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    uint32_t a = x0[b * stride], c = x1[b * stride];
    if (INV) {  // v ^= u first
      a ^= (a & mu) << d;
      c ^= (c & mu) << d;
    }
    v[b] = ((a & mv) >> d) | (c & mv);
  }
  Bs<5>::mul(m, v, sc);
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const uint32_t a = x0[b * stride], c = x1[b * stride];
    const uint32_t ua = (a ^ sc[b]) & mu, uc = (c ^ ((sc[b] & mv) >> d)) & mu;
    if (!INV) {  // u ^= t v; v ^= u
      x0[b * stride] = ua | ((a ^ (ua << d)) & mv);
      x1[b * stride] = uc | ((c ^ (uc << d)) & mv);
    } else {     // v ^= u; u ^= t v
      x0[b * stride] = ua | ((a ^ ((a & mu) << d)) & mv);
      x1[b * stride] = uc | ((c ^ ((c & mu) << d)) & mv);
    }
  }
}

// A stage's delta masks as butterfly_intra_packed reads them: the v half
// moved into the u positions, and in place.
__device__ __forceinline__ uint32_t pack_deltas(uint32_t delta, int d) {
  const uint32_t mv = ~intra_mask_u(d);
  return ((delta & mv) >> d) | (delta & mv);
}

// One (u, v) word pair of one group; plane b of u at u[b * stride].
template <bool INV>
__device__ __forceinline__ void butterfly_pair(uint32_t* u, uint32_t* v,
                                               long long stride, uint32_t tw) {
  uint32_t m[32], x[32], sc[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) m[b] = 0u - ((tw >> b) & 1u);
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

// 16 bytes from global to shared memory without passing through registers
__device__ __forceinline__ void copy16_async(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

constexpr int kThreads = 256;
constexpr int kMaxLocalStages = 32;
constexpr int kMetaWords = 33;  // per stage: d_elems, then 32 delta masks

// K3. Grid (n_words / tile, groups). meta[s] = {d_elems, 32 delta masks}.
// Shared memory: the tile [32][tile], then the stages' twiddle rows
// [n_stages][tile]. A stage's pairs go two to a thread: word pairs
// (wu, wu + dw) at word distance dw, or for an intra-word stage the words
// (k, k + tile / 2) under one packed network.
template <bool INV>
__global__ void __launch_bounds__(kThreads, 1)
    ntt_local_kernel(uint32_t* __restrict__ planes, const uint32_t* __restrict__ tw,
                     const int* __restrict__ meta, int n_stages, int n_words, int tile) {
  extern __shared__ uint32_t sm[];
  __shared__ uint32_t s_meta[kMaxLocalStages * kMetaWords];
  uint32_t* s_tw = sm + 32 * tile;
  const long long t0 = (long long)blockIdx.x * tile;
  uint32_t* base = planes + (long long)blockIdx.y * 32 * n_words + t0;
  const int quads = tile / 4;  // 16-byte copies per plane or twiddle row
  for (int i = threadIdx.x; i < 32 * quads; i += kThreads)
    copy16_async(sm + 4 * i, base + (long long)(i / quads) * n_words + 4 * (i % quads));
  for (int i = threadIdx.x; i < n_stages * quads; i += kThreads)
    copy16_async(s_tw + 4 * i, tw + (long long)(i / quads) * n_words + t0 + 4 * (i % quads));
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < n_stages * kMetaWords; i += kThreads) {
    const int d = meta[i - i % kMetaWords];
    s_meta[i] = i % kMetaWords && d < 32 ? pack_deltas((uint32_t)meta[i], d) : (uint32_t)meta[i];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int half = tile / 2;
  for (int s = 0; s < n_stages; ++s) {
    const int d = (int)s_meta[s * kMetaWords];
    const uint32_t* twr = s_tw + s * tile;
    if (d < 32) {
      for (int k = threadIdx.x; k < half; k += kThreads)
        butterfly_intra_packed<INV>(sm + k, sm + k + half, tile, twr[k], twr[k + half],
                                    s_meta + s * kMetaWords + 1, d);
    } else {
      const int dw = d >> 5, lg = __ffs(dw) - 1;
      for (int k = threadIdx.x; k < half; k += kThreads) {
        const int wu = ((k >> lg) << (lg + 1)) | (k & (dw - 1));
        butterfly_pair<INV>(sm + wu, sm + wu + dw, tile, twr[wu]);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 32 * quads; i += kThreads)
    *reinterpret_cast<uint4*>(base + (long long)(i / quads) * n_words + 4 * (i % quads)) =
        *reinterpret_cast<const uint4*>(sm + 4 * i);
}

constexpr int kMaxCrossStages = 7;
constexpr int kCrossWords = 1 << 15;  // tile words per group: 32 planes x 1024 = 128 KB

// K4. Tile [32 planes][2^s words of the run's bits][cols low words], where
// cols = 2^15 / 32 / 2^s (8 at s = 7: a 32-byte sector per plane row), so
// a block always holds 512 word pairs per stage, 2 per thread. Grid
// (n_words / 2^(lo_bit + s) * 2^lo_bit / cols, groups). `tw` holds the
// run's twiddle rows in execution order; a forward run takes its highest
// bit first, an inverse run its lowest.
template <bool INV>
__global__ void __launch_bounds__(kThreads, 1)
    ntt_cross_kernel(uint32_t* __restrict__ planes, const uint32_t* __restrict__ tw,
                     int n_words, int lo_bit, int n_stages, int cols) {
  extern __shared__ uint32_t sm[];
  const int mid = 1 << n_stages;
  const int row = mid * cols;  // tile words per plane
  const int quads = cols / 4;  // 16-byte copies per plane row
  const long long chunks = (1ll << lo_bit) / cols;
  const long long w0 = ((long long)(blockIdx.x / chunks) << (lo_bit + n_stages)) +
                       (long long)(blockIdx.x % chunks) * cols;
  uint32_t* base = planes + (long long)blockIdx.y * 32 * n_words + w0;
  // (plane, word of the run's bits, quad of the row) -> 16 bytes
  auto gaddr = [&](int i) {
    return base + (long long)(i / (quads * mid)) * n_words +
           ((long long)((i / quads) & (mid - 1)) << lo_bit) + 4 * (i % quads);
  };
  for (int i = threadIdx.x; i < 8 * row; i += blockDim.x) copy16_async(sm + 4 * i, gaddr(i));
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int k = 0; k < n_stages; ++k) {
    const int b = INV ? k : n_stages - 1 - k;  // the stage's bit in the tile
    const uint32_t* twr = tw + (long long)k * n_words + w0;
    for (int q = threadIdx.x; q < row / 2; q += blockDim.x) {
      const int col = q % cols, pair = q / cols;
      const int mu = ((pair >> b) << (b + 1)) | (pair & ((1 << b) - 1));
      butterfly_pair<INV>(sm + mu * cols + col, sm + (mu + (1 << b)) * cols + col, row,
                          twr[((long long)mu << lo_bit) + col]);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 8 * row; i += blockDim.x)
    *reinterpret_cast<uint4*>(gaddr(i)) = *reinterpret_cast<const uint4*>(sm + 4 * i);
}

}  // namespace

extern "C" int k3_ntt_local(void* planes, const void* tw, const void* meta,
                            int n_stages, int n_words, int groups, int tile,
                            int inverse, void* stream) {
  if (n_stages < 1 || n_stages > kMaxLocalStages || tile < 4 || tile % 4 ||
      n_words % tile)
    return (int)cudaErrorInvalidValue;
  const int smem = (32 + n_stages) * tile * (int)sizeof(uint32_t);
  auto kernel = inverse ? ntt_local_kernel<true> : ntt_local_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_words / tile, groups);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (uint32_t*)planes, (const uint32_t*)tw, (const int*)meta, n_stages, n_words, tile);
  return (int)cudaGetLastError();
}

// Stages at word distances 2^lo_bit .. 2^(lo_bit + n_stages - 1), in
// execution order, fused in one pass.
extern "C" int k4_ntt_cross(void* planes, const void* tw, int n_words, int groups,
                            int lo_bit, int n_stages, int inverse, void* stream) {
  if (n_stages < 1 || n_stages > kMaxCrossStages || lo_bit < 0 || lo_bit > 30 ||
      n_words % (1ll << (lo_bit + n_stages)))
    return (int)cudaErrorInvalidValue;
  const int cols = (kCrossWords / 32 >> n_stages) < (1 << lo_bit) ? kCrossWords / 32 >> n_stages
                                                                  : 1 << lo_bit;
  if (cols < 4) return (int)cudaErrorInvalidValue;
  const int smem = 32 * (cols << n_stages) * (int)sizeof(uint32_t);
  const long long blocks = (long long)n_words / cols >> n_stages;
  dim3 grid((unsigned)blocks, groups);
  auto kernel = inverse ? ntt_cross_kernel<true> : ntt_cross_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (uint32_t*)planes, (const uint32_t*)tw, n_words, lo_bit, n_stages, cols);
  return (int)cudaGetLastError();
}

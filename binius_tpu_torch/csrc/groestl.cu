// K5 and K6: Grøstl-256 for the Merkle commit.
//
// K5 replaces `_leaf_kernel` (binius_tpu/hash/groestl_pallas.py, launched by
// `_leaf_call_impl`): the full Grøstl-256 digest of each Merkle leaf. K6
// replaces `_pairs_kernel` (launched by `_pairs_call_impl`): the 2-to-1
// compression trunc256(P(a||b) ^ (a||b)) of each digest pair.
//
// The TPU kernels bitslice the state only to stay free of gathers. Hopper
// gathers from shared memory cheaply, so both kernels run the classic
// 64-bit-column T-table Grøstl (the formulation of the host
// `_permute_cols` in hash/groestl.py): one thread per leaf (K5) or per pair
// (K6), the state as 8 column words (byte i of a column = state row i), and
// SubBytes+MixBytes as 8 lookups per column in the 8 x 256 x 8 B = 16 KB of
// T-tables that each block copies into shared memory. The tables and round
// constants come from the host, derived from first principles in
// hash/groestl.py; no constant of the cipher lives here.
//
// Bound on the H100: the permutation's work. A leaf of 256 B costs 11
// permutations (5 compressions of P and Q, then the output transform) of
// 10 rounds x 64 table lookups and XORs, far above the 288 B it moves.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 10;
constexpr int kTableWords = 8 * 256;
// tables layout: T[8][256], then P constants [10][8], then Q constants [10][8]
constexpr int kConstWords = kTableWords + 2 * kRounds * 8;

__device__ __forceinline__ void load_tables(const uint64_t* __restrict__ g,
                                            uint64_t* s) {
  for (int i = threadIdx.x; i < kConstWords; i += blockDim.x) s[i] = g[i];
  __syncthreads();
}

// P (Q = false) or Q permutation on 8 column words.
template <bool Q>
__device__ __forceinline__ void permute(uint64_t* x, const uint64_t* s) {
  const uint64_t* T = s;
  const uint64_t* rc = s + kTableWords + (Q ? kRounds * 8 : 0);
  // row i of the state rotates left by i columns in P, and in Q by
  // (1, 3, 5, 7, 0, 2, 4, 6)[i]
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    uint64_t a[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) a[c] = x[c] ^ rc[r * 8 + c];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint64_t acc = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int sh = Q ? (i < 4 ? 2 * i + 1 : 2 * i - 8) : i;
        const uint32_t byte = (uint32_t)(a[(c + sh) & 7] >> (8 * i)) & 0xFFu;
        acc ^= T[i * 256 + byte];
      }
      x[c] = acc;
    }
  }
}

__device__ __forceinline__ uint64_t bswap64(uint64_t v) {
  uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
  return ((uint64_t)__byte_perm(lo, 0, 0x0123) << 32) |
         __byte_perm(hi, 0, 0x0123);
}

// K5. One thread per leaf of `blob_words` 64-bit words.
__global__ void __launch_bounds__(kThreads)
    leaf_kernel(const uint64_t* __restrict__ cw, int n_leaves, int blob_words,
                const uint64_t* __restrict__ tables,
                uint64_t* __restrict__ out) {
  __shared__ uint64_t s[kConstWords];
  load_tables(tables, s);
  const long long leaf = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (leaf >= n_leaves) return;
  // Grøstl-256 padding: 0x80, zeros, the block count as a big-endian u64
  const int n_blocks = (blob_words * 8 + 8) / 64 + 1;
  const int last = n_blocks * 8 - 1;
  const uint64_t* m_src = cw + leaf * blob_words;
  uint64_t h[8] = {0, 0, 0, 0, 0, 0, 0, 1ull << 48};  // IV: byte 62 = 0x01
  for (int k = 0; k < n_blocks; ++k) {
    uint64_t m[8], hm[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int idx = k * 8 + c;
      uint64_t v;
      if (idx < blob_words)
        v = m_src[idx];
      else
        v = (idx == blob_words ? 0x80ull : 0ull) ^
            (idx == last ? bswap64((uint64_t)n_blocks) : 0ull);
      m[c] = v;
      hm[c] = h[c] ^ v;
    }
    permute<false>(hm, s);
    permute<true>(m, s);
#pragma unroll
    for (int c = 0; c < 8; ++c) h[c] ^= hm[c] ^ m[c];
  }
  uint64_t x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = h[c];
  permute<false>(x, s);
#pragma unroll
  for (int c = 4; c < 8; ++c) out[leaf * 4 + (c - 4)] = x[c] ^ h[c];
}

// K6. One thread per pair of 32-byte digests.
__global__ void __launch_bounds__(kThreads)
    pairs_kernel(const uint64_t* __restrict__ dig, int n_pairs,
                 const uint64_t* __restrict__ tables,
                 uint64_t* __restrict__ out) {
  __shared__ uint64_t s[kConstWords];
  load_tables(tables, s);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  uint64_t m[8], x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = m[c] = dig[i * 8 + c];
  permute<false>(x, s);
#pragma unroll
  for (int c = 4; c < 8; ++c) out[i * 4 + (c - 4)] = x[c] ^ m[c];
}

}  // namespace

extern "C" int k5_groestl_leaf(const void* cw, int n_leaves, int blob_words,
                               const void* tables, void* out, void* stream) {
  unsigned blocks = (unsigned)((n_leaves + kThreads - 1) / kThreads);
  leaf_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)cw, n_leaves, blob_words, (const uint64_t*)tables,
      (uint64_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int k6_groestl_pairs(const void* digests, int n_pairs,
                                const void* tables, void* out, void* stream) {
  unsigned blocks = (unsigned)((n_pairs + kThreads - 1) / kThreads);
  pairs_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)digests, n_pairs, (const uint64_t*)tables,
      (uint64_t*)out);
  return (int)cudaGetLastError();
}

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
// `_permute_cols` in hash/groestl.py): the state is 8 column words (byte i
// of a column = state row i), and SubBytes+MixBytes of one output column is
// 8 table lookups, T_i[byte i of input column (c + shift_i) & 7], XORed.
// The tables and round constants come from the host, derived from first
// principles in hash/groestl.py; no constant of the cipher lives here.
//
// K5 is bounded on the H100 by its lookups: a leaf of 256 B costs 11
// permutations (5 compressions of P and Q, then the output transform) of
// 10 rounds x 64 lookups of 8 bytes, far above the 288 B it moves. Per
// 32 lanes a 64-bit shared-memory load takes at least two wavefronts (one
// per half warp), and only if the 16 lanes of a half warp hit 16 distinct
// bank pairs. Its design:
//  * One table. T_i[x] is T_0[x] rotated left by i bytes, and T_(i+4) is
//    T_i with its 32-bit halves swapped. So a column is
//    sum_j rotl(T_0[x_j] ^ swap(T_0[x_(j+4)]), 8j) over j < 4: 8 lookups,
//    the swaps free, 3 rotations of 2 byte permutes each.
//  * Bank-conflict-free lookups, one instruction per address. T_0 (2 KB)
//    is stored 32 times, interleaved: entry x of copy k at byte 256x + 8k.
//    Lane l reads copy l, so every half warp hits 16 distinct bank pairs
//    whatever the bytes and each lookup instruction takes the minimum two
//    wavefronts; and the address is one byte permute of the input word
//    (byte j into byte 1) and the lane's 8l (into byte 0). 64 KB of shared
//    memory in all.
//  * Two kernels by shape. `leaf_kernel`, one thread per leaf, runs the
//    most leaves per lookup and serves many short leaves. `leaf_lanes_kernel`
//    gives a leaf 16 cooperating lanes: lanes 0-7 run P(h ^ m) and lanes
//    8-15 run Q(m) on the same instructions, lane c holding column c; the
//    bytes of a round's input columns come by `__shfl_sync` within each
//    group of 8. Q(m) no longer sits on the chain, and a round's dependent
//    work is 8 lookups, not 64, so a leaf of 257 blocks (a 16 KiB FRI leaf)
//    is a chain of 257 P permutations plus the output transform, about 8x
//    shorter per round, and few leaves still fill many SMs. The wrapper
//    picks by leaf count (hash/groestl_cuda.py, LANES_BELOW), from the times
//    of both at the opening's shapes on the card.
//  * Message blocks prefetched one block ahead into registers; a lane group
//    reads a 64-byte block in one coalesced request.
//
// K6 applies P only (trunc256(P(a||b) ^ (a||b))), 10 rounds of 64 lookups
// per pair, over the same one-table form, and runs every level of the tree
// to the root on the card, every level written into one buffer:
//  * Wide levels: `pairs_kernel`, one launch per level, one thread per pair.
//  * The tail: a narrow level is too little work for a launch of its own
//    (a launch of one-thread pairs costs about 9.5 us below 2^15 pairs,
//    most of it one thread's chain of 10 rounds of 64 lookups).
//    `tail_kernel` runs every level from a given one to the root in one
//    cooperative launch, 8 lanes per pair (lane c holds column c, a round's
//    bytes by width-8 shuffles as in `leaf_lanes_kernel`, so a pair's chain
//    is 10 rounds of 8 lookups). A level spreads over all resident blocks
//    with a grid barrier after it; from the level that fits one block on,
//    block 0 runs alone, levels separated by `__syncthreads`. Its floor is
//    that chain: the number of levels x 10 rounds. The wrapper picks the
//    level at which the tail starts (hash/groestl_cuda.py, TAIL_PAIRS) from
//    the times of both forms at the opening's tree shapes on the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRounds = 10;
// the host's table layout: T[8][256], then P constants [10][8], then Q
// constants [10][8]; the kernels read T_0 and the constants
constexpr int kTableWords = 8 * 256;

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

constexpr int kCopies = 32;                // interleaved copies of T_0, one per lane
constexpr int kT0Words = 256 * kCopies;
constexpr int kT0Smem = (kT0Words + 2 * kRounds * 8) * 8;  // 66,816 B
constexpr int kLeafThreads = 256;          // leaf_kernel: leaves per block
constexpr int kLaneThreads = 256;          // leaf_lanes_kernel: 16 leaves
constexpr int kLanes = 16;
constexpr int kPairThreads = 256;          // pairs_kernel: pairs per block

__device__ __forceinline__ uint32_t lo32(uint64_t v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t hi32(uint64_t v) { return (uint32_t)(v >> 32); }
__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return ((uint64_t)hi << 32) | lo;
}

// T_0 in 32 interleaved copies, then the P and Q round constants. Thread x
// stores entry x's copies in an order rotated by x, so the 16 lanes of a
// half warp store to 16 distinct bank pairs.
__device__ __forceinline__ void load_t0(const uint64_t* __restrict__ g,
                                        uint64_t* s) {
  for (int x = threadIdx.x; x < 256; x += blockDim.x) {
    const uint64_t v = g[x];
#pragma unroll
    for (int k = 0; k < kCopies; ++k) s[x * kCopies + ((k + x) & (kCopies - 1))] = v;
  }
  for (int i = threadIdx.x; i < 2 * kRounds * 8; i += blockDim.x)
    s[kT0Words + i] = g[kTableWords + i];
  __syncthreads();
}

// The lane's copy of T_0[byte j (0..3) of w]: byte offset 256 x + 8 lane,
// with 8 lane in byte 0 of `lane8`
__device__ __forceinline__ uint64_t lookup(const uint64_t* t0, uint32_t w, uint32_t lane8,
                                           int j) {
  const uint32_t off = __byte_perm(w, lane8, 0x5504 | (j << 4));
  return *reinterpret_cast<const uint64_t*>(reinterpret_cast<const char*>(t0) + off);
}

// rotl(y0, 0) ^ rotl(y1, 8) ^ rotl(y2, 16) ^ rotl(y3, 24) on 64-bit words
// given as halves, by byte permutes
__device__ __forceinline__ uint64_t combine(const uint32_t* lo, const uint32_t* hi) {
  const uint32_t l = lo[0] ^ __byte_perm(lo[1], hi[1], 0x2107) ^
                     __byte_perm(lo[2], hi[2], 0x1076) ^ __byte_perm(lo[3], hi[3], 0x0765);
  const uint32_t h = hi[0] ^ __byte_perm(hi[1], lo[1], 0x2107) ^
                     __byte_perm(hi[2], lo[2], 0x1076) ^ __byte_perm(hi[3], lo[3], 0x0765);
  return join(l, h);
}

// One output column, sum_i T_i[x_i]: x_j is byte j of w_lo[j], x_(j+4)
// byte j of w_hi[j] (the high halves of their columns). T_0 is the shared
// table (`t0`, all copies), `lane8` 8 x the lane.
__device__ __forceinline__ uint64_t lookups(const uint64_t* t0, uint32_t lane8,
                                            const uint32_t* w_lo, const uint32_t* w_hi) {
  uint32_t ylo[4], yhi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t a = lookup(t0, w_lo[j], lane8, j);
    const uint64_t b = lookup(t0, w_hi[j], lane8, j);
    ylo[j] = lo32(a) ^ hi32(b);  // swap(b): T_(j+4) = T_j with halves swapped
    yhi[j] = hi32(a) ^ lo32(b);
  }
  return combine(ylo, yhi);
}

// P (Q = false) or Q on 8 column words held by one thread.
template <bool Q>
__device__ __forceinline__ void permute_thread(uint64_t* x, const uint64_t* t0,
                                               uint32_t lane8, const uint64_t* rc) {
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint64_t a = x[c] ^ rc[r * 8 + c];
      lo[c] = lo32(a);
      hi[c] = hi32(a);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t wl[4], wh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = Q ? 2 * j + 1 : j;      // shift of row j
        const int sh = Q ? 2 * j : j + 4;      // shift of row j + 4
        wl[j] = lo[(c + sl) & 7];
        wh[j] = hi[(c + sh) & 7];
      }
      x[c] = lookups(t0, lane8, wl, wh);
    }
  }
}

// Word idx of leaf block k's padded message: the blob, then 0x80, zeros and
// the block count as a big-endian u64 (Grøstl-256 padding).
__device__ __forceinline__ uint64_t message_word(const uint64_t* __restrict__ src,
                                                 int idx, int blob_words, int n_blocks) {
  if (idx < blob_words) return src[idx];
  uint64_t v = idx == blob_words ? 0x80ull : 0ull;
  if (idx == n_blocks * 8 - 1) {
    const uint64_t n = (uint64_t)n_blocks;
    v ^= ((uint64_t)__byte_perm((uint32_t)n, 0, 0x0123) << 32) |
         __byte_perm((uint32_t)(n >> 32), 0, 0x0123);
  }
  return v;
}

constexpr uint64_t kIvCol7 = 1ull << 48;  // IV: byte 62 = 0x01

// K5, many leaves: one thread per leaf of `blob_words` 64-bit words.
__global__ void __launch_bounds__(kLeafThreads)
    leaf_kernel(const uint64_t* __restrict__ cw, int n_leaves, int blob_words,
                const uint64_t* __restrict__ tables, uint64_t* __restrict__ out) {
  extern __shared__ uint64_t s[];
  load_t0(tables, s);
  const long long leaf = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (leaf >= n_leaves) return;
  const uint32_t lane8 = (threadIdx.x & 31) * 8;
  const uint64_t* rc_p = s + kT0Words;
  const uint64_t* rc_q = rc_p + kRounds * 8;
  const int n_blocks = (blob_words * 8 + 8) / 64 + 1;
  const uint64_t* src = cw + leaf * blob_words;
  uint64_t h[8] = {0, 0, 0, 0, 0, 0, 0, kIvCol7};
  uint64_t m[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) m[c] = message_word(src, c, blob_words, n_blocks);
  for (int k = 0; k < n_blocks; ++k) {
    uint64_t next[8], hm[8];
    const bool more = k + 1 < n_blocks;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      next[c] = more ? message_word(src, (k + 1) * 8 + c, blob_words, n_blocks) : 0;
      hm[c] = h[c] ^ m[c];
    }
    permute_thread<false>(hm, s, lane8, rc_p);
    permute_thread<true>(m, s, lane8, rc_q);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      h[c] ^= hm[c] ^ m[c];
      m[c] = next[c];
    }
  }
  uint64_t x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = h[c];
  permute_thread<false>(x, s, lane8, rc_p);
#pragma unroll
  for (int c = 4; c < 8; ++c) out[leaf * 4 + (c - 4)] = x[c] ^ h[c];
}

// K5, few or long leaves: 16 lanes per leaf. Lane t of a group: column
// c = t & 7 of P (t < 8) or of Q (t >= 8). One round on the lane's column
// a (the round constant XORed in): byte i of column (c + shift_i) & 7 by a
// shuffle of its half within the group of 8, then the 8 lookups.
__device__ __forceinline__ uint64_t round_lanes(uint64_t a, const int* src,
                                                const uint64_t* t0, uint32_t lane8,
                                                unsigned mask) {
  uint32_t wl[4], wh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wl[j] = __shfl_sync(mask, lo32(a), src[j], 8);
    wh[j] = __shfl_sync(mask, hi32(a), src[j + 4], 8);
  }
  return lookups(t0, lane8, wl, wh);
}

__global__ void __launch_bounds__(kLaneThreads)
    leaf_lanes_kernel(const uint64_t* __restrict__ cw, int n_leaves, int blob_words,
                      const uint64_t* __restrict__ tables, uint64_t* __restrict__ out) {
  extern __shared__ uint64_t s[];
  load_t0(tables, s);
  const long long leaf = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  if (leaf >= n_leaves) return;  // whole groups: the 16 lanes share a leaf
  const unsigned mask = 0xFFFFu << (threadIdx.x & 16);
  const int t = threadIdx.x & (kLanes - 1), c = t & 7;
  const bool q = t >= 8;
  int src[8];  // the lane (within the 8) that holds byte i of this lane's input
#pragma unroll
  for (int i = 0; i < 8; ++i) src[i] = (c + (q ? (i < 4 ? 2 * i + 1 : 2 * i - 8) : i)) & 7;
  const uint32_t lane8 = (threadIdx.x & 31) * 8;
  const uint64_t* rc = s + kT0Words + (q ? kRounds * 8 : 0) + c;
  const uint64_t* rc_p = s + kT0Words + c;
  const int n_blocks = (blob_words * 8 + 8) / 64 + 1;
  const uint64_t* msrc = cw + leaf * blob_words;
  uint64_t h = c == 7 ? kIvCol7 : 0;  // P lanes carry the chaining value
  uint64_t m = message_word(msrc, c, blob_words, n_blocks);
  for (int k = 0; k < n_blocks; ++k) {
    const uint64_t next =
        k + 1 < n_blocks ? message_word(msrc, (k + 1) * 8 + c, blob_words, n_blocks) : 0;
    uint64_t x = q ? m : h ^ m;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) x = round_lanes(x ^ rc[r * 8], src, s, lane8, mask);
    h ^= x ^ __shfl_sync(mask, x, c + 8, kLanes);  // P lanes: h ^ P(h ^ m) ^ Q(m)
    m = next;
  }
  uint64_t x = h;  // the output transform P(h) ^ h on the P lanes
#pragma unroll
  for (int r = 0; r < kRounds; ++r) x = round_lanes(x ^ rc_p[r * 8], src, s, lane8, mask);
  if (!q && c >= 4) out[leaf * 4 + (c - 4)] = x ^ h;
}

// K6, a wide level: one thread per pair of 32-byte digests.
__global__ void __launch_bounds__(kPairThreads)
    pairs_kernel(const uint64_t* __restrict__ dig, int n_pairs,
                 const uint64_t* __restrict__ tables, uint64_t* __restrict__ out) {
  extern __shared__ uint64_t s[];
  load_t0(tables, s);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const uint32_t lane8 = (threadIdx.x & 31) * 8;
  uint64_t m[8], x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = m[c] = dig[i * 8 + c];
  permute_thread<false>(x, s, lane8, s + kT0Words);
#pragma unroll
  for (int c = 4; c < 8; ++c) out[i * 4 + (c - 4)] = x[c] ^ m[c];
}

constexpr int kTailThreads = 1024;               // 8 lanes per pair
constexpr int kTailPairs = kTailThreads / 8;     // pairs per block and pass

// The tail's grid barrier: generation and arrival count, zero at load.
__device__ unsigned g_tail_gen = 0, g_tail_arrived = 0;

// Every block of the (cooperative, co-resident) grid meets here; what any
// block wrote before it is visible to all after it, at L2 (read with
// __ldcg: a line cached in L1 before may hold the next level's bytes).
__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = &g_tail_gen;
    const unsigned mine = *gen;
    __threadfence();
    if (atomicAdd(&g_tail_arrived, 1) == gridDim.x - 1) {
      g_tail_arrived = 0;
      __threadfence();
      atomicAdd(&g_tail_gen, 1);
    } else {
      while (*gen == mine) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// K6, the tail: the level of `n_pairs` pairs at `in`, and every level
// above it to the root, in one cooperative launch. Level j + 1 follows
// level j in `out` (n_pairs >> j digests of 4 words each). A level spreads
// its pairs over every block; once a level fits one block (kTailPairs
// pairs), the other blocks leave and block 0 runs the rest alone,
// levels separated by __syncthreads. `in` and `out` are not __restrict__
// const: each level reads what the grid wrote before.
__global__ void __launch_bounds__(kTailThreads, 1)
    tail_kernel(const uint64_t* in, int n_pairs, const uint64_t* __restrict__ tables,
                uint64_t* out) {
  extern __shared__ uint64_t s[];
  load_t0(tables, s);
  const int c = threadIdx.x & 7;
  const unsigned mask = 0xFFu << (threadIdx.x & 24);
  int src[8];  // the lane (within the 8) that holds byte i of this lane's input
#pragma unroll
  for (int i = 0; i < 8; ++i) src[i] = (c + i) & 7;
  const uint32_t lane8 = (threadIdx.x & 31) * 8;
  const uint64_t* rc = s + kT0Words + c;
  for (int n = n_pairs; n >= 1; n >>= 1) {
    for (int p = blockIdx.x * kTailPairs + (threadIdx.x >> 3); p < n;
         p += gridDim.x * kTailPairs) {
      const uint64_t m = __ldcg(reinterpret_cast<const unsigned long long*>(in) + p * 8 + c);
      uint64_t x = m;
#pragma unroll
      for (int r = 0; r < kRounds; ++r) x = round_lanes(x ^ rc[r * 8], src, s, lane8, mask);
      if (c >= 4) out[p * 4 + (c - 4)] = x ^ m;
    }
    if (n > kTailPairs) {
      grid_barrier();
    } else if (blockIdx.x) {
      return;
    } else {
      __syncthreads();
    }
    in = out;
    out += 4 * n;
  }
}

}  // namespace

// `lanes` picks leaf_lanes_kernel (16 lanes per leaf) over leaf_kernel.
extern "C" int k5_groestl_leaf(const void* cw, int n_leaves, int blob_words,
                               const void* tables, void* out, int lanes, void* stream) {
  if (n_leaves < 1 || blob_words < 1) return (int)cudaErrorInvalidValue;
  const auto* c = (const uint64_t*)cw;
  const auto* t = (const uint64_t*)tables;
  auto* o = (uint64_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  // above 48 KB of shared memory a kernel runs only on request
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e =
        cudaFuncSetAttribute(leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kT0Smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(leaf_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kT0Smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  if (lanes) {
    const long long threads = (long long)n_leaves * kLanes;
    const unsigned blocks = (unsigned)((threads + kLaneThreads - 1) / kLaneThreads);
    leaf_lanes_kernel<<<blocks, kLaneThreads, kT0Smem, s>>>(c, n_leaves, blob_words, t, o);
  } else {
    const unsigned blocks = (unsigned)((n_leaves + kLeafThreads - 1) / kLeafThreads);
    leaf_kernel<<<blocks, kLeafThreads, kT0Smem, s>>>(c, n_leaves, blob_words, t, o);
  }
  return (int)cudaGetLastError();
}

// `tail` runs tail_kernel: the level at `digests` and every level above it,
// written one after another from `out`; else the one level into `out`.
extern "C" int k6_groestl_pairs(const void* digests, int n_pairs, const void* tables, void* out,
                                int tail, void* stream) {
  if (n_pairs < 1 || (tail && (n_pairs & (n_pairs - 1)))) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e =
        cudaFuncSetAttribute(pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kT0Smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kT0Smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const auto* d = (const uint64_t*)digests;
  const auto* t = (const uint64_t*)tables;
  auto* o = (uint64_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (tail) {  // as many blocks as the level needs, all resident at once
    static int resident = 0;
    if (!resident) {
      int dev, sms, per_sm;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tail_kernel, kTailThreads,
                                                          kT0Smem);
      if (e != cudaSuccess) return (int)e;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      resident = sms * per_sm;
    }
    const int need = (n_pairs + kTailPairs - 1) / kTailPairs;
    void* args[] = {&d, &n_pairs, &t, &o};
    return (int)cudaLaunchCooperativeKernel((const void*)tail_kernel,
                                            need < resident ? need : resident, kTailThreads,
                                            args, kT0Smem, s);
  } else {
    const unsigned blocks = (unsigned)((n_pairs + kPairThreads - 1) / kPairThreads);
    pairs_kernel<<<blocks, kPairThreads, kT0Smem, s>>>(d, n_pairs, t, o);
  }
  return (int)cudaGetLastError();
}

// K1: element-wise binary tower multiplication, packed in and packed out,
// levels 5..7 (B32, B64, B128).
//
// Replaces `bitslice_pallas.mul` (binius_tpu/fields/bitslice_pallas.py),
// which is `from_bitsliced . mul_planes . to_bitsliced`: the operands go to
// bit planes (`_transpose32_kernel`), `_mul_kernel` runs the Karatsuba gate
// network `bitslice._mul_bs` on them, and the product comes back. Here the
// three steps are one launch and the planes never leave shared memory.
//
// Data: a, b and out are packed (n, limbs) uint32 (limbs 1, 2, 4); either
// operand may instead be one element (a scalar), read in place. In bit
// planes a scalar's plane is 0 or 0xFFFFFFFF in every word, so a block
// builds its planes once from the scalar's limbs and no batch is copied out.
// n need not be a multiple of 32: loads past n read zero words, which are
// absorbing for the network, and stores past n are masked.
//
// Bound on the H100, per word column of 32 B128 elements: 13,448 two-input
// gates of the network plus 15 per word for each of the three transposes
// (5,760), against 3 x 512 bytes; at 64 32-bit logic results per clock per
// SM, two gates per LOP3, the operations bound B128 (and the bytes B32).
//
// Design, per tile of kCols = 32 word columns (1,024 elements):
//  1. Load: a warp takes whole columns; lane i reads element 32w + i with
//     one 4/8/16-byte access (a warp reads 128/256/512 contiguous bytes),
//     and the warp transpose (bs_transpose.cuh, all of a warp's words
//     round by round) turns the 32 rows of each limb into 32 plane words,
//     stored in shared memory at plane stride kCols + 1 (conflict-free for
//     the column writes here and for the row reads below).
//  2. Products: a B128 product is 3 B64 products of (low halves, high
//     halves, their XOR) and each of those 3 B32 products: 9 B32 products
//     per column (3 for B64, 1 for B32). One thread takes one (column,
//     product): warp p, lane c. It forms its 32 + 32 input planes as XORs
//     of the selected 32-plane quarters from shared memory, runs the
//     unrolled B32 network of tower_bs.cuh in registers (the code K3/K4
//     run) and writes its 32 product planes back.
//  3. Recombination: the Karatsuba step z0 ^ z2 low, mid ^ z0 ^ z2 ^
//     alpha * z2 high, at the B64 and then the B128 level, one 32-plane
//     quarter of the result per (column, thread), over shared memory.
//  4. Store: the warp transpose turns the result planes back into packed
//     elements, written with one vector store per lane.
// The B32 network holds a thread at 168 registers, so an SM holds 12
// warps. `mul_kernel` takes one tile per block of 1, 3 or 9 warps (B32,
// B64, B128), 12, 4 or 1 blocks to an SM, every warp in every step; the
// blocks on an SM overlap each other's steps, except at B128, where a
// block is alone on its SM and its loads and transposes leave the issue
// slots idle. So a large B128 batch runs `mul128_kernel` instead: one
// block per SM loops over tiles with 3 more warps that only load: they
// stage tile t+2's packed operands in shared memory with cp.async and turn
// tile t+1's into planes while the 9 product warps run tile t's steps 2-4
// (172,160 bytes of shared memory). Its pipeline fills only when each SM
// has several tiles; below that `mul_kernel<7>` is faster. The caller
// picks (`persistent`), from the sizes at which each was faster on the
// card (binius_tpu_torch/fields/bitslice_cuda.py, B128_PERSISTENT_FROM).

#include <cstdint>
#include <cuda_runtime.h>

#include "bs_transpose.cuh"
#include "tower_bs.cuh"

namespace {

using bs_transpose::load_elem;
using bs_transpose::store_elem;
using bs_transpose::WarpTranspose;
using tower_bs::Bs;

constexpr int kCols = 32;      // word columns per block
constexpr int kS = kCols + 1;  // plane stride in shared memory

// `mul_kernel`: one warp per B32 product, every warp in every step.
template <int L>
struct Level {
  static constexpr int LIMBS = 1 << (L - 5);
  static constexpr int NB = 32 * LIMBS;                   // bit planes
  static constexpr int NP = L == 5 ? 1 : L == 6 ? 3 : 9;  // B32 products = warps
  static constexpr int THREADS = 32 * NP;
  static constexpr int MIN_BLOCKS = L == 5 ? 12 : L == 6 ? 4 : 1;
  static constexpr int SMEM_BYTES = (2 * NB + 32 * NP) * kS * 4;
};

// `mul128_kernel`: 9 product warps and 3 mover warps; shared memory for
// two tiles of operand planes, the 9 B32 products (later the result) and
// the stage of a tile's packed operands.
constexpr int kMovers = 3;
constexpr int kThreads128 = 32 * (9 + kMovers);
constexpr int kStageWords = 2 * 32 * kCols * 4;  // both operands of a tile, packed
constexpr int kSmem128 = (2 * 256 + 288) * kS * 4 + kStageWords * 4;

// The half selection of one Karatsuba step: the low half, the high half,
// or their XOR, as a bit mask over the two halves.
__device__ __forceinline__ unsigned half_sel(int k) {
  return k == 0 ? 1u : k == 1 ? 2u : 3u;
}

// A group of NW warps that moves whole word columns of a tile between
// packed memory and planes in shared memory (plane q, column c at
// s[q * kS + c]); warp w of the group takes columns w, w + NW, ..., CH of
// them at a time.
template <int LIMBS, int NW, int CH>
struct Mover {
  static constexpr int PER = (kCols + NW - 1) / NW;  // columns per warp
  static constexpr int WORDS = CH * LIMBS;           // words per lane and batch

  // Issue the loads of columns i0..i0 + CH of one operand into
  // v[i * LIMBS + g] (zero words past n).
  __device__ __forceinline__ static void load(const uint32_t* __restrict__ src, long long n,
                                              long long col0, int w, int i0, uint32_t* v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int col = w + (i0 + i) * NW;
      const long long e = (col0 + col) * 32 + lane;
      if (col < kCols && e < n) {
        load_elem<LIMBS>(src + e * LIMBS, v + i * LIMBS);
      } else {
#pragma unroll
        for (int g = 0; g < LIMBS; ++g) v[i * LIMBS + g] = 0u;
      }
    }
  }

  // The loaded columns to planes in s.
  __device__ __forceinline__ static void put(uint32_t* v, uint32_t* s, int w, int i0,
                                             const WarpTranspose& tr) {
    const int lane = threadIdx.x & 31;
    tr.apply<WORDS>(v);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int col = w + (i0 + i) * NW;
      if (col >= kCols) break;  // warp-uniform
#pragma unroll
      for (int g = 0; g < LIMBS; ++g) s[(32 * g + lane) * kS + col] = v[i * LIMBS + g];
    }
  }

  // A scalar's planes: 32 * LIMBS words s[q], the same for every column,
  // built by the group's threads (this one is number `it`).
  __device__ __forceinline__ static void put_scalar(const uint32_t* __restrict__ src,
                                                    uint32_t* s, int it) {
    for (int q = it; q < 32 * LIMBS; q += 32 * NW) s[q] = 0u - ((src[q >> 5] >> (q & 31)) & 1u);
  }

  // Both operands of a tile to planes in sa and sb, the loads of both
  // operands of a batch in flight together.
  __device__ __forceinline__ static void fetch(const uint32_t* __restrict__ a, int a_scalar,
                                               const uint32_t* __restrict__ b, int b_scalar,
                                               long long n, long long col0, int w, int it,
                                               uint32_t* sa, uint32_t* sb,
                                               const WarpTranspose& tr) {
    if (a_scalar) put_scalar(a, sa, it);
    if (b_scalar) put_scalar(b, sb, it);
#pragma unroll
    for (int i0 = 0; i0 < PER; i0 += CH) {
      uint32_t va[WORDS], vb[WORDS];
      if (!a_scalar) load(a, n, col0, w, i0, va);
      if (!b_scalar) load(b, n, col0, w, i0, vb);
      if (!a_scalar) put(va, sa, w, i0, tr);
      if (!b_scalar) put(vb, sb, w, i0, tr);
    }
  }

  // A tile staged in shared memory as packed elements (element 32c + i of
  // the tile at staged[(32c + i) * LIMBS]) to planes in s.
  __device__ __forceinline__ static void put_staged(const uint32_t* staged, uint32_t* s,
                                                    int w, const WarpTranspose& tr) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i0 = 0; i0 < PER; i0 += CH) {
      uint32_t v[WORDS];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int col = min(w + (i0 + i) * NW, kCols - 1);
        load_elem<LIMBS>(staged + (32 * col + lane) * LIMBS, v + i * LIMBS);
      }
      put(v, s, w, i0, tr);
    }
  }

  // The result planes in s back to packed elements (masked past n).
  __device__ __forceinline__ static void store(const uint32_t* s, uint32_t* __restrict__ out,
                                               long long n, long long col0, int w,
                                               const WarpTranspose& tr) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i0 = 0; i0 < PER; i0 += CH) {
      uint32_t v[WORDS];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int col = min(w + (i0 + i) * NW, kCols - 1);
#pragma unroll
        for (int g = 0; g < LIMBS; ++g) v[i * LIMBS + g] = s[(32 * g + lane) * kS + col];
      }
      tr.apply<WORDS>(v);
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int col = w + (i0 + i) * NW;
        const long long idx = (col0 + col) * 32 + lane;
        if (col < kCols && idx < n) store_elem<LIMBS>(out + idx * LIMBS, v + i * LIMBS);
      }
    }
  }
};

// x[k] = XOR over the 32-plane quarters q selected by `mask` of plane
// 32q + k at column c (plane stride ps, column stride cs: (kS, 1) for a
// batch, (1, 0) for a scalar).
template <int NQ>
__device__ __forceinline__ void gather(const uint32_t* s, int ps, int cs, int c,
                                       unsigned mask, uint32_t* x) {
#pragma unroll
  for (int k = 0; k < 32; ++k) x[k] = 0u;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (!((mask >> q) & 1u)) continue;
    const uint32_t* p = s + 32 * q * ps + c * cs;
#pragma unroll
    for (int k = 0; k < 32; ++k) x[k] ^= p[k * ps];
  }
}

__device__ __forceinline__ void read32(const uint32_t* s, int q, int c, uint32_t* x) {
#pragma unroll
  for (int k = 0; k < 32; ++k) x[k] = s[(32 * q + k) * kS + c];
}

// One 32-plane quarter j of a Karatsuba step's result, at column c: from
// the half products z0 (low x low), z2 (high x high) and mid, each HQ
// quarters, the low half is z0 ^ z2 and the high half
// mid ^ z0 ^ z2 ^ alpha(z2) (tower_bs.cuh `Bs<L>::mul`); alpha of HQ = 1
// quarter is Bs<5>::alpha, of HQ = 2 quarters (h0, h1) it is
// (h1, h0 ^ Bs<5>::alpha(h1)).
template <int HQ>
__device__ __forceinline__ void combine(const uint32_t* z0, const uint32_t* z2,
                                        const uint32_t* mid, int j, int c,
                                        uint32_t* dst) {
  const int jj = j < HQ ? j : j - HQ;
  uint32_t r[32], t[32];
  read32(z0, jj, c, r);
  read32(z2, jj, c, t);
#pragma unroll
  for (int k = 0; k < 32; ++k) r[k] ^= t[k];
  if (j >= HQ) {
    read32(mid, jj, c, t);
#pragma unroll
    for (int k = 0; k < 32; ++k) r[k] ^= t[k];
    uint32_t al[32];
    if (HQ == 1 || jj == 1) {  // alpha(z2) holds Bs<5>::alpha of z2's top quarter
      read32(z2, HQ - 1, c, t);
      Bs<5>::alpha(t, al);
#pragma unroll
      for (int k = 0; k < 32; ++k) r[k] ^= al[k];
    }
    if (HQ == 2) {  // and the other quarter of z2, moved across
      read32(z2, 1 - jj, c, t);
#pragma unroll
      for (int k = 0; k < 32; ++k) r[k] ^= t[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) dst[(32 * j + k) * kS + c] = r[k];
}

// Step 2 for thread (warp p, lane c): B32 product p of column c, written
// to planes 32p..32p+31 of sz. Product p = 3 s7 + s6 selects halves s7 at
// the B128 level and s6 at the B64 level (0 low, 1 high, 2 XOR).
template <int LIMBS>
__device__ __forceinline__ void product(const uint32_t* sa, int a_scalar, const uint32_t* sb,
                                        int b_scalar, int p, int c, uint32_t* sz) {
  unsigned mask = 1u;
  if constexpr (LIMBS == 2) mask = half_sel(p);
  if constexpr (LIMBS == 4) {
    const unsigned m6 = half_sel(p % 3), m7 = half_sel(p / 3);
    mask = ((m7 & 1u) ? m6 : 0u) | ((m7 & 2u) ? m6 << 2 : 0u);
  }
  uint32_t x[32], y[32], z[32];
  gather<LIMBS>(sa, a_scalar ? 1 : kS, a_scalar ? 0 : 1, c, mask, x);
  gather<LIMBS>(sb, b_scalar ? 1 : kS, b_scalar ? 0 : 1, c, mask, y);
  Bs<5>::mul(x, y, z);
#pragma unroll
  for (int k = 0; k < 32; ++k) sz[(32 * p + k) * kS + c] = z[k];
}

// One tile per block, one warp per product; every warp moves.
template <int L>
__global__ void __launch_bounds__(Level<L>::THREADS, Level<L>::MIN_BLOCKS)
    mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, long long n, int a_scalar,
               int b_scalar) {
  using Lv = Level<L>;
  using Mv = Mover<Lv::LIMBS, Lv::NP, (kCols + Lv::NP - 1) / Lv::NP>;
  extern __shared__ uint32_t sm[];
  uint32_t* sa = sm;                  // operand a, later the B64 products
  uint32_t* sb = sm + Lv::NB * kS;    // operand b
  uint32_t* sz = sb + Lv::NB * kS;    // the B32 products
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long col0 = (long long)blockIdx.x * kCols;
  const WarpTranspose tr;

  Mv::fetch(a, a_scalar, b, b_scalar, n, col0, warp, threadIdx.x, sa, sb, tr);  // 1.
  __syncthreads();
  product<Lv::LIMBS>(sa, a_scalar, sb, b_scalar, warp, lane, sz);  // 2.
  __syncthreads();
  const uint32_t* so = sz;
  if constexpr (L == 6) {  // 3. the B64 Karatsuba step
    if (warp < 2) combine<1>(sz, sz + 32 * kS, sz + 64 * kS, warp, lane, sa);
    __syncthreads();
    so = sa;
  }
  if constexpr (L == 7) {  // 3. the B64 and then the B128 Karatsuba steps
    if (warp < 6) {  // B64 product s7 = warp / 2, quarter warp % 2, into sa and sb
      const uint32_t* z = sz + (warp / 2) * 96 * kS;
      combine<1>(z, z + 32 * kS, z + 64 * kS, warp % 2, lane, sa + (warp / 2) * 64 * kS);
    }
    __syncthreads();
    if (warp < 4) combine<2>(sa, sa + 64 * kS, sa + 128 * kS, warp, lane, sz);
    __syncthreads();
  }
  Mv::store(so, out, n, col0, warp, tr);  // 4.
}

// The 9 product warps' own barrier (named barrier 1; the movers go on),
// and the 3 mover warps' (named barrier 2).
__device__ __forceinline__ void product_warps_sync() {
  asm volatile("bar.sync 1, 288;" ::: "memory");
}
__device__ __forceinline__ void mover_warps_sync() {
  asm volatile("bar.sync 2, 96;" ::: "memory");
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async); `bytes` 0 fills zeros.
__device__ __forceinline__ void copy16_async(uint32_t* dst, const uint32_t* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

// B128: one block per SM loops over tiles with specialised warps. While
// warps 0-8 run tile t's products, recombination and store, the 3 mover
// warps turn tile t+1's operands (staged in shared memory) into planes in
// the other operand buffer and start the copy of tile t+2's operands into
// the stage with cp.async, so a tile's loads have a whole iteration to
// land and the transposes in overlap the gate network.
__global__ void __launch_bounds__(kThreads128, 1)
    mul128_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  uint32_t* __restrict__ out, long long n, int a_scalar,
                  int b_scalar) {
  using In = Mover<4, kMovers, (kCols + kMovers - 1) / kMovers>;
  using Out = Mover<4, 9, 4>;
  extern __shared__ uint32_t sm[];
  uint32_t* ops = sm;                   // [2][a 128 | b 128 planes]; after the
                                        // products, the three B64 products
  uint32_t* sz = sm + 2 * 256 * kS;     // the 9 B32 products, then the result
  uint32_t* stage = sz + 288 * kS;      // [a | b][1024 packed elements]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool mover = warp >= 9;
  const int w = warp - 9, it = threadIdx.x - 288;
  const long long tiles = ((n + 31) / 32 + kCols - 1) / kCols;
  const long long step = gridDim.x;
  const WarpTranspose tr;

  auto issue = [&](long long tile) {  // movers: start the copy of a tile's operands
    for (int k = it; k < 32 * kCols; k += 32 * kMovers) {
      const long long e = tile * 32 * kCols + k;
      const bool in = e < n;
      if (!a_scalar) copy16_async(stage + 4 * k, in ? a + 4 * e : a, in ? 16 : 0);
      if (!b_scalar) copy16_async(stage + 4 * (32 * kCols + k), in ? b + 4 * e : b, in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto unstage = [&](uint32_t* op) {  // movers: the staged tile to planes in op
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    mover_warps_sync();
    if (a_scalar) In::put_scalar(a, op, it);
    else In::put_staged(stage, op, w, tr);
    if (b_scalar) In::put_scalar(b, op + 128 * kS, it);
    else In::put_staged(stage + 4 * 32 * kCols, op + 128 * kS, w, tr);
    mover_warps_sync();
  };

  if (mover && blockIdx.x < tiles) {
    issue(blockIdx.x);
    unstage(ops);
    if (blockIdx.x + step < tiles) issue(blockIdx.x + step);
  }
  __syncthreads();
  int buf = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += step, buf ^= 1) {
    uint32_t* op = ops + buf * 256 * kS;
    if (!mover) {
      // 2. the 9 B32 products, 3. the B64 and B128 Karatsuba steps, 4. out
      product<4>(op, a_scalar, op + 128 * kS, b_scalar, warp, lane, sz);
      product_warps_sync();
      if (warp < 6) {  // B64 product s7 = warp / 2, quarter warp % 2
        const uint32_t* z = sz + (warp / 2) * 96 * kS;
        combine<1>(z, z + 32 * kS, z + 64 * kS, warp % 2, lane, op + (warp / 2) * 64 * kS);
      }
      product_warps_sync();
      if (warp < 4) combine<2>(op, op + 64 * kS, op + 128 * kS, warp, lane, sz);
      product_warps_sync();
      Out::store(sz, out, n, tile * kCols, warp, tr);
    } else if (tile + step < tiles) {
      // 1. the next tile's operands in, and the copy of the one after started
      unstage(ops + (buf ^ 1) * 256 * kS);
      if (tile + 2 * step < tiles) issue(tile + 2 * step);
    }
    __syncthreads();
  }
}

// Above 48 KB of shared memory a kernel runs only on request.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

template <int L>
int launch(const uint32_t* a, const uint32_t* b, uint32_t* out, long long n,
           int a_scalar, int b_scalar, int persistent, cudaStream_t s) {
  const long long tiles = ((n + 31) / 32 + kCols - 1) / kCols;
  if constexpr (L == 7) {
    if (persistent) {
      static bool smem_set = false;
      static int sms = 0;
      cudaError_t e = allow_smem(mul128_kernel, kSmem128, smem_set);
      if (e == cudaSuccess && !sms) {
        int dev = 0;
        e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      }
      if (e != cudaSuccess) return (int)e;
      const long long blocks = tiles < sms ? tiles : sms;  // one per SM, looping over tiles
      mul128_kernel<<<(unsigned)blocks, kThreads128, kSmem128, s>>>(a, b, out, n, a_scalar,
                                                                    b_scalar);
      return (int)cudaGetLastError();
    }
  }
  using Lv = Level<L>;
  static bool smem_set = false;
  const cudaError_t e = allow_smem(mul_kernel<L>, Lv::SMEM_BYTES, smem_set);
  if (e != cudaSuccess) return (int)e;
  mul_kernel<L><<<(unsigned)tiles, Lv::THREADS, Lv::SMEM_BYTES, s>>>(a, b, out, n, a_scalar,
                                                                    b_scalar);
  return (int)cudaGetLastError();
}

}  // namespace

// out[i] = a[i] * b[i] for i < n at `level` (5..7), packed (n, limbs)
// uint32; an operand with its flag set is one element, used for every i.
// `persistent` (level 7 only) runs mul128_kernel instead of mul_kernel<7>.
extern "C" int k1_tower_mul(const void* a, const void* b, void* out, int level,
                            long long n, int a_scalar, int b_scalar, int persistent,
                            void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const auto* pa = (const uint32_t*)a;
  const auto* pb = (const uint32_t*)b;
  auto* po = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (level == 5) return launch<5>(pa, pb, po, n, a_scalar, b_scalar, 0, s);
  if (level == 6) return launch<6>(pa, pb, po, n, a_scalar, b_scalar, 0, s);
  if (level == 7) return launch<7>(pa, pb, po, n, a_scalar, b_scalar, persistent, s);
  return (int)cudaErrorInvalidValue;
}

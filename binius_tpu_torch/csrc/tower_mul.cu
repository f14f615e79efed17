// K1: element-wise binary tower multiplication on bit planes, levels 5..7.
//
// Replaces `_mul_kernel` (binius_tpu/fields/bitslice_pallas.py, launched by
// `mul_planes`), which runs the whole Karatsuba gate network
// `bitslice._mul_bs` on one VMEM block of planes per grid step.
//
// Data: planes [2^L, W] (plane b holds bit b of 32 consecutive elements,
// one uint32 word per 32 elements); out = a * b in the same layout. One
// thread owns one word column w, so a warp reads 32 neighbouring words of a
// plane at a time.
//
// Bound on the H100, per word: the network has 1,388 / 4,355 / 13,448
// two-input gates at B32 / B64 / B128 (`mul_gates` in chip_smoke.py), and
// the kernel moves 3 * 2^L * 4 bytes (two operands in, one out). At
// 33.5 T 32-bit operations/s and 3.35 TB/s the bytes bound all three levels,
// B128 narrowly (1,536 B at 0.46 ns against 13,448 ops at 0.40 ns).
//
// Registers: a B128 column has 256 input planes, more than a thread's 255
// registers. The kernel walks the top Karatsuba levels instead: a B128
// product is 3 B64 products of (halves, their XOR), each of those 3 B32
// products, so 9 B32 products in all. Each one forms its 32 + 32 input
// planes as XORs of the selected 32-plane quarters while loading them, runs
// the unrolled B32 network of `tower_bs.cuh` in registers (the same code as
// K3/K4), and XORs its result, with the mul_alpha terms of the Karatsuba
// recombination, into the thread's accumulators in shared memory (64 planes
// for the B64 product in flight and 128 output planes; plane k of a thread
// at [k * kThreads + threadIdx.x], so a warp's accesses fall in 32 distinct
// banks). The 9 products re-read each input quarter 4 times; those re-reads
// are served from L1/L2 rather than HBM when the block's columns are close.

#include <cstdint>
#include <cuda_runtime.h>

#include "tower_bs.cuh"

namespace {

using tower_bs::Bs;

constexpr int kThreads = 128;

// x[p] = XOR over the 32-plane quarters q selected by `mask` of
// src[(32 q + p) * W]; src already points at the thread's column.
template <int NQ>
__device__ __forceinline__ void load_sel(const uint32_t* __restrict__ src,
                                         long long W, unsigned mask,
                                         uint32_t* x) {
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    uint32_t v = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if ((mask >> q) & 1u) v ^= __ldg(src + (long long)(32 * q + p) * W);
    x[p] = v;
  }
}

// The half selection of one Karatsuba step: the low half, the high half,
// or their XOR, as a bit mask over the two halves.
__device__ __forceinline__ unsigned half_sel(int k) {
  return k == 0 ? 1u : k == 1 ? 2u : 3u;
}

// T[0..64) = the B64 product of the 64-plane operands picked by sel7 (bit 0:
// the low 64 planes, bit 1: the high 64; NQ = 2 when the operands are B64).
// t points at the thread's first accumulator plane; plane k is t[k * S].
template <int NQ>
__device__ __forceinline__ void mul64_to_smem(const uint32_t* __restrict__ a,
                                              const uint32_t* __restrict__ b,
                                              long long W, unsigned sel7,
                                              uint32_t* t) {
  constexpr int S = kThreads;
#pragma unroll 1
  for (int j = 0; j < 3; ++j) {
    const unsigned s6 = half_sel(j);
    const unsigned mask = ((sel7 & 1u) ? s6 : 0u) | ((sel7 & 2u) ? s6 << 2 : 0u);
    uint32_t x[32], y[32], p[32];
    load_sel<NQ>(a, W, mask, x);
    load_sel<NQ>(b, W, mask, y);
    Bs<5>::mul(x, y, p);
    if (j == 0) {  // z0: low and high
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        t[k * S] = p[k];
        t[(32 + k) * S] = p[k];
      }
    } else if (j == 1) {  // z2: low, and high with alpha * z2
      uint32_t al[32];
      Bs<5>::alpha(p, al);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        t[k * S] ^= p[k];
        t[(32 + k) * S] ^= p[k] ^ al[k];
      }
    } else {  // the middle product: high only
#pragma unroll
      for (int k = 0; k < 32; ++k) t[(32 + k) * S] ^= p[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    mul32_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                 long long W) {
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  uint32_t x[32], y[32], p[32];
  load_sel<1>(a + w, W, 1u, x);
  load_sel<1>(b + w, W, 1u, y);
  Bs<5>::mul(x, y, p);
#pragma unroll
  for (int k = 0; k < 32; ++k) out[(long long)k * W + w] = p[k];
}

__global__ void __launch_bounds__(kThreads)
    mul64_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                 long long W) {
  extern __shared__ uint32_t sm[];  // [64][kThreads]
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  uint32_t* t = sm + threadIdx.x;
  mul64_to_smem<2>(a + w, b + w, W, 1u, t);
#pragma unroll 8
  for (int k = 0; k < 64; ++k) out[(long long)k * W + w] = t[k * kThreads];
}

__global__ void __launch_bounds__(kThreads)
    mul128_kernel(const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                  long long W) {
  constexpr int S = kThreads;
  extern __shared__ uint32_t sm[];  // [64 + 128][kThreads]
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  uint32_t* t = sm + threadIdx.x;    // the B64 product in flight
  uint32_t* o = t + 64 * S;          // the 128 output planes
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    mul64_to_smem<4>(a + w, b + w, W, half_sel(i), t);
    if (i == 0) {  // z0: low and high
#pragma unroll 8
      for (int k = 0; k < 64; ++k) {
        o[k * S] = t[k * S];
        o[(64 + k) * S] = t[k * S];
      }
    } else if (i == 1) {
      // z2: low, and high with alpha_6 * z2 = (z2_hi, z2_lo ^ alpha_5 z2_hi)
      uint32_t hi[32], al[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) hi[k] = t[(32 + k) * S];
      Bs<5>::alpha(hi, al);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const uint32_t lo = t[k * S];
        o[k * S] ^= lo;
        o[(32 + k) * S] ^= hi[k];
        o[(64 + k) * S] ^= lo ^ hi[k];
        o[(96 + k) * S] ^= hi[k] ^ lo ^ al[k];
      }
    } else {  // the middle product: high only
#pragma unroll 8
      for (int k = 0; k < 64; ++k) o[(64 + k) * S] ^= t[k * S];
    }
  }
#pragma unroll 8
  for (int k = 0; k < 128; ++k) out[(long long)k * W + w] = o[k * S];
}

}  // namespace

extern "C" int k1_tower_mul(const void* a, const void* b, void* out, int level,
                            long long n_words, void* stream) {
  if (n_words < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_words + kThreads - 1) / kThreads));
  const auto* pa = (const uint32_t*)a;
  const auto* pb = (const uint32_t*)b;
  auto* po = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (level == 5) {
    mul32_kernel<<<grid, kThreads, 0, s>>>(pa, pb, po, n_words);
  } else if (level == 6) {
    const size_t smem = (size_t)64 * kThreads * sizeof(uint32_t);
    mul64_kernel<<<grid, kThreads, smem, s>>>(pa, pb, po, n_words);
  } else if (level == 7) {
    const size_t smem = (size_t)(64 + 128) * kThreads * sizeof(uint32_t);
    cudaFuncSetAttribute(mul128_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    mul128_kernel<<<grid, kThreads, smem, s>>>(pa, pb, po, n_words);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

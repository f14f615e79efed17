// The bitsliced Karatsuba network of the binary tower, shared by K1
// (tower_mul.cu) and K3/K4 (ntt.cu).
//
// An element at level L is 2^L bit planes: plane b holds bit b of 32
// consecutive elements, one uint32 word per 32 elements. The network is
// `bitslice._mul_bs` gate for gate: Karatsuba to the 1-bit base case,
// z0 ^ z2 low and z1 ^ alpha * z2 high. Fully unrolled by the templates, a
// B32 product (1,388 gates) keeps its 32 + 32 inputs, 32 outputs and the
// temporaries in registers.

#pragma once

#include <cstdint>

namespace tower_bs {

template <int L>
struct Bs {
  static constexpr int N = 1 << L;
  static constexpr int H = N >> 1;

  // out = a * X_L (mirrors bitslice._mul_alpha_bs)
  __device__ __forceinline__ static void alpha(const uint32_t* a,
                                               uint32_t* out) {
    if constexpr (L == 0) {
      out[0] = a[0];
    } else {
      uint32_t t[H];
      Bs<L - 1>::alpha(a + H, t);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        out[i] = a[H + i];
        out[H + i] = a[i] ^ t[i];
      }
    }
  }

  // out = a * b, Karatsuba to the 1-bit base case (bitslice._mul_bs)
  __device__ __forceinline__ static void mul(const uint32_t* a,
                                             const uint32_t* b,
                                             uint32_t* out) {
    if constexpr (L == 0) {
      out[0] = a[0] & b[0];
    } else {
      uint32_t z0[H], z2[H], mid[H], as[H], bs[H], al[H];
      Bs<L - 1>::mul(a, b, z0);
      Bs<L - 1>::mul(a + H, b + H, z2);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        as[i] = a[i] ^ a[H + i];
        bs[i] = b[i] ^ b[H + i];
      }
      Bs<L - 1>::mul(as, bs, mid);
      Bs<L - 1>::alpha(z2, al);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        uint32_t lo = z0[i] ^ z2[i];
        out[i] = lo;
        out[H + i] = mid[i] ^ lo ^ al[i];
      }
    }
  }
};

}  // namespace tower_bs


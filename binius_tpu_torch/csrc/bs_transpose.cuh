// The warp-level 32x32 bit transpose shared by K1 (tower_mul.cu) and K2
// (transpose32.cu), and the packed element loads and stores around it.
//
// Lane i holds row i of a 32x32 bit block (one uint32 word). Five
// __shfl_xor_sync rounds at distance 16, 8, 4, 2, 1 swap the off-diagonal
// sub-blocks of each size with the Hacker's Delight 7-3 masks, after which
// lane b holds the word whose bit i is bit b of row i. It is the operation
// of `bitslice._transpose32` and of the JAX `_transpose32_kernel`
// (binius_tpu/fields/bitslice_pallas.py): with lane i holding limb g of
// element 32w + i, lane b ends up holding word w of bit plane 32g + b.

#pragma once

#include <cstdint>

namespace bs_transpose {

struct WarpTranspose {
  // Per lane and round r (distance j = 16 >> r): the bits the lane takes
  // from its partner, and the left rotation that brings them into place.
  // The lower lane k takes the keep bits of row k + j shifted up by j; the
  // upper lane k + j takes the other bits of row k shifted down by j. A
  // rotation serves for the shift, because the bits it wraps around land
  // outside the mask.
  uint32_t take[5];
  int rot[5];

  __device__ __forceinline__ WarpTranspose() {
    const unsigned lane = threadIdx.x & 31u;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int j = 16 >> r;
      const uint32_t keep = r == 0   ? 0xFFFF0000u
                            : r == 1 ? 0xFF00FF00u
                            : r == 2 ? 0xF0F0F0F0u
                            : r == 3 ? 0xCCCCCCCCu
                                     : 0xAAAAAAAAu;
      const bool upper = lane & j;
      take[r] = upper ? ~keep : keep;
      rot[r] = upper ? 32 - j : j;
    }
  }

  // Transposes M independent blocks x[0..M) (M words per lane), round by
  // round, so that the shuffles of one round are in flight together: one
  // shuffle, one funnel shift and one LOP3 per word and round.
  template <int M>
  __device__ __forceinline__ void apply(uint32_t* x) const {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      uint32_t y[M];
#pragma unroll
      for (int m = 0; m < M; ++m) y[m] = __shfl_xor_sync(0xFFFFFFFFu, x[m], 16 >> r);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const uint32_t moved = __funnelshift_l(y[m], y[m], rot[r]);
        x[m] = (x[m] & ~take[r]) | (moved & take[r]);
      }
    }
  }
};

// One packed element of LIMBS uint32 limbs (1, 2 or 4), read into or
// written from w[0..LIMBS) with one 4-, 8- or 16-byte access, so that a
// warp's 32 neighbouring elements are 32 * 4 * LIMBS contiguous bytes.
template <int LIMBS>
__device__ __forceinline__ void load_elem(const uint32_t* __restrict__ p, uint32_t* w) {
  if constexpr (LIMBS == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (LIMBS == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

template <int LIMBS>
__device__ __forceinline__ void store_elem(uint32_t* __restrict__ p, const uint32_t* w) {
  if constexpr (LIMBS == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (LIMBS == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *p = w[0];
  }
}

}  // namespace bs_transpose

"""Multilinear extensions over the boolean hypercube.

The port of `binius_tpu/math/mle.py` (`multilinear_extension.rs`,
`multilinear_query.rs`), plain PyTorch on the caller's device. An n-variate
multilinear is stored as its 2^n hypercube evaluations; index bit i is
variable i (variable 0 the LSB).
"""

from __future__ import annotations

import dataclasses

import torch

from ..fields import tower

LEVEL = 7   # the query field (B128)


@dataclasses.dataclass(frozen=True)
class MLE:
    """Multilinear extension: 2^n_vars evaluations of a T_level polynomial."""

    data: torch.Tensor   # the canonical layout of `level`
    level: int
    n_vars: int

    def __post_init__(self):
        expect = tower.elem_shape(self.level, (1 << self.n_vars,))
        assert tuple(self.data.shape) == expect, (self.data.shape, expect)


def eq_ind_partial_eval(level: int, point: torch.Tensor) -> torch.Tensor:
    """Tensor-product eq-indicator expansion of a query point (k,[limbs]):
    2^k entries E[j] = prod_i (j_i ? r_i : 1 + r_i)."""
    e = tower.full(level, (1,), 1, device=point.device)
    for i in range(tower.batch_shape(level, point)[0]):
        e1 = tower.mul(level, e, point[i])
        e = torch.cat([e ^ e1, e1], dim=0)   # e * (1 + r) = e + e * r
    return e


def _promote(level_a: int, a: torch.Tensor, level_b: int, b: torch.Tensor):
    """Embed the lower-level operand; returns (level, a, b)."""
    if level_a == level_b:
        return level_a, a, b
    if level_a < level_b:
        return level_b, tower.embed(level_a, level_b, a), b
    return level_a, a, tower.embed(level_b, level_a, b)


def evaluate_partial_low(level: int, data: torch.Tensor, n_vars: int, q_level: int,
                         q_expansion: torch.Tensor, k: int):
    """Bind the k lowest variables to a query given as its eq expansion:
    out[j] = sum_{i < 2^k} E[i] * data[(j << k) | i]. Returns (level, out)."""
    out_level, d, e = _promote(level, data, q_level, q_expansion)
    d = d.reshape(tower.elem_shape(out_level, (1 << (n_vars - k), 1 << k)))
    return out_level, tower.inner_product(out_level, d, e, axis=1)


def evaluate_partial_high(level: int, data: torch.Tensor, n_vars: int, q_level: int,
                          q_expansion: torch.Tensor, k: int):
    """Bind the k highest variables: out[i] = sum_j E[j] * data[(j << (n-k)) | i].
    Returns (level, out)."""
    out_level, d, e = _promote(level, data, q_level, q_expansion)
    d = d.reshape(tower.elem_shape(out_level, (1 << k, 1 << (n_vars - k))))
    return out_level, tower.inner_product(out_level, d, e[:, None], axis=0)


def evaluate(level: int, data: torch.Tensor, n_vars: int, q_level: int, point: torch.Tensor):
    """Full evaluation at a point of shape (n_vars,[limbs])."""
    e = eq_ind_partial_eval(q_level, point)
    out_level, out = evaluate_partial_low(level, data, n_vars, q_level, e, n_vars)
    return out_level, out[0]


def eq_ind(level: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """eq(x, y) = prod_i (x_i y_i + (1 + x_i)(1 + y_i)) for points (k,[limbs])."""
    one = tower.full(level, (), 1, device=x.device)
    t = tower.mul(level, x, y) ^ tower.mul(level, x ^ one, y ^ one)
    out = one
    for i in range(tower.batch_shape(level, t)[0]):
        out = tower.mul(level, out, t[i])
    return out


# float64 0/1 entries held at once by the GF(2) projection (128 MiB)
_GF2_CHUNK_ELEMS = 1 << 24


def _bits_chunk(level: int, stack: torch.Tensor, j0: int, jc: int, keep: int) -> torch.Tensor:
    """Rows j0..j0+jc of the (k, 2^kh, 2^keep) bit matrix of a B1 stack, as
    float64 (k, 2^keep, jc): unpacked lanes (level 0) or P1 words."""
    k = stack.shape[0]
    if level == tower.P1:
        words = stack[:, (j0 << keep) // 32:((j0 + jc) << keep) // 32]
        bits = tower.unpack_b1(words)
    else:
        bits = stack[:, j0 << keep:(j0 + jc) << keep]
    return bits.reshape(k, jc, 1 << keep).transpose(1, 2).to(torch.float64)


def batched_evaluate_partial_high(level: int, stack: torch.Tensor, n_vars: int,
                                  eq: torch.Tensor, keep: int):
    """Bind the high n_vars - keep variables of k stacked multilinears to a
    B128 query given as its eq expansion (2^(n_vars - keep), 4):
    out[m, i] = sum_j eq[j] * stack[m, (j << keep) | i], (k, 2^keep, 4) B128.

    `level` may be `tower.P1` (stack of bit-packed words). For B1 data the
    sum is a GF(2) matrix product of the data's bit matrix with eq's bits,
    taken as exact float64 counts in row chunks; other levels scale eq by
    the subfield data."""
    k = stack.shape[0]
    kh = n_vars - keep
    if level in (0, tower.P1):
        jc = max(1, _GF2_CHUNK_ELEMS // (k << keep))
        jc = min(1 << kh, max(1 << (jc.bit_length() - 1), 32 >> min(keep, 5)))
        counts = torch.zeros((k, 1 << keep, 128), dtype=torch.float64, device=stack.device)
        for j0 in range(0, 1 << kh, jc):
            counts += torch.matmul(_bits_chunk(level, stack, j0, jc, keep),
                                   tower.to_bits(LEVEL, eq[j0:j0 + jc]))
        return LEVEL, tower.from_bits(LEVEL, torch.remainder(counts, 2))
    d = stack.reshape(tower.elem_shape(level, (k, 1 << kh, 1 << keep)))
    p = tower.scale_subfield(level, LEVEL, d, eq[None, :, None, :])
    return LEVEL, tower.xor_reduce(p, 1)


def batched_evaluate_partial_low(level: int, stack: torch.Tensor, n_vars: int,
                                 coeffs: torch.Tensor, bind: int):
    """Bind the low `bind` variables of k stacked multilinears with a B128
    coefficient vector (an eq expansion or Lagrange coefficients)
    (2^bind, 4): out[m, j] = sum_i coeffs[i] * stack[m, (j << bind) | i],
    (k, 2^(n_vars - bind), 4) B128.

    `level` may be `tower.P1`. For B1 data the sum is a GF(2) matrix
    product of the data's bit rows with the coefficients' bits, taken as
    exact float64 counts in row chunks; other levels scale the coefficients
    by the subfield data."""
    k = stack.shape[0]
    kh = n_vars - bind
    if level in (0, tower.P1):
        cbits = tower.to_bits(LEVEL, coeffs)                 # (2^bind, 128)
        jc = max(1, _GF2_CHUNK_ELEMS // (k << bind))
        jc = min(1 << kh, max(1 << (jc.bit_length() - 1), 32 >> min(bind, 5)))
        outs = []
        for j0 in range(0, 1 << kh, jc):
            if level == tower.P1:
                bits = tower.unpack_b1(stack[:, (j0 << bind) // 32:((j0 + jc) << bind) // 32])
            else:
                bits = stack[:, j0 << bind:(j0 + jc) << bind]
            counts = torch.matmul(bits.reshape(k, jc, 1 << bind).to(torch.float64), cbits)
            outs.append(tower.from_bits(LEVEL, torch.remainder(counts, 2)))
        return LEVEL, torch.cat(outs, dim=1)
    d = stack.reshape(tower.elem_shape(level, (k, 1 << kh, 1 << bind)))
    p = tower.scale_subfield(level, LEVEL, d, coeffs[None, None])
    return LEVEL, tower.xor_reduce(p, 2)

"""Fold helpers: bind sumcheck or FRI variables to challenges.

The port of `binius_tpu/math/fold.py` (the fold family of
`crates/math/src/fold.rs` and `crates/hal/src/sumcheck_folding.rs`), plain
PyTorch on the caller's device. Subfield data is promoted to the
challenge's level; products at levels 5..7 are K1 launches on the card.
"""

from __future__ import annotations

import torch

from ..fields import tower
from .mle import _promote


def extrapolate_line(level: int, x0: torch.Tensor, x1: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
    """x0 + (x1 + x0) * z, element-wise (z broadcasts)."""
    return x0 ^ tower.mul(level, x0 ^ x1, z)


def fold_low(level: int, data: torch.Tensor, n_vars: int, r_level: int, r: torch.Tensor):
    """Bind variable 0 (the LSB): out[j] = d[2j] + r (d[2j] + d[2j+1]).
    Returns (out_level, 2^(n_vars-1) elements)."""
    out_level, d, rr = _promote(level, data, r_level, r)
    e0, e1 = evals_01(out_level, d, n_vars, order_high=False)
    return out_level, extrapolate_line(out_level, e0, e1, rr)


def fold_high(level: int, data: torch.Tensor, n_vars: int, r_level: int, r: torch.Tensor):
    """Bind variable n_vars-1 (the MSB): out[i] = d[i] + r (d[i] + d[i + half])."""
    out_level, d, rr = _promote(level, data, r_level, r)
    e0, e1 = evals_01(out_level, d, n_vars, order_high=True)
    return out_level, extrapolate_line(out_level, e0, e1, rr)


def zero_pad(level: int, data: torch.Tensor, n_vars: int, n_pad_vars: int,
             nonzero_index: int, front: bool) -> torch.Tensor:
    """Embed a 2^n_vars block into a 2^(n_vars + n_pad_vars) hypercube, zero
    elsewhere (`crates/math/src/fold.rs:27`): with `front` the new index is
    (old << n_pad_vars) | nonzero_index, else (nonzero_index << n_vars) | old."""
    k = n_pad_vars
    shape = (1 << n_vars, 1 << k) if front else (1 << k, 1 << n_vars)
    out = tower.zeros(level, shape, device=data.device)
    if front:
        out[:, nonzero_index] = data
    else:
        out[nonzero_index] = data
    return out.reshape(tower.elem_shape(level, (1 << (n_vars + k),)))


def evals_01(level: int, data: torch.Tensor, n_vars: int, order_high: bool):
    """(evaluations at X = 0, at X = 1) of the folding variable: the MSB's
    halves with `order_high`, else the LSB's even and odd entries."""
    if order_high:
        half = 1 << (n_vars - 1)
        return data[:half], data[half:]
    d = data.reshape(tower.elem_shape(level, (1 << (n_vars - 1), 2)))
    return d[:, 0], d[:, 1]


def fold_middle(level: int, data: torch.Tensor, n_vars: int, q_level: int,
                q_expansion: torch.Tensor, k: int, start: int):
    """Bind k variables from `start` to a query given as its eq expansion:
    out[(j << start) | i] = sum_q E[q] d[(j << (start + k)) | (q << start) | i]
    (`crates/math/src/fold.rs:189-240`). Returns (out_level, out)."""
    assert n_vars >= k + start
    out_level, d, e = _promote(level, data, q_level, q_expansion)
    d = d.reshape(tower.elem_shape(out_level, (1 << (n_vars - k - start), 1 << k, 1 << start)))
    e = e[None, :, None]
    out = tower.inner_product(out_level, d, e, axis=1)
    return out_level, out.reshape(tower.elem_shape(out_level, (1 << (n_vars - k),)))

"""FRI-Binius PIOP: the batch commitment of multilinears.

Counterpart of the commit part of `binius_tpu/protocols/piop.py`:
`CommitMeta` (multilinears grouped by packed n_vars), `pack_multilinear`,
`merge_multilins` (pieces most-vars-first, each bit-reversed, zero-padded
to 2^total_vars), `make_commit_params` and `commit`. The sumcheck-FRI
`prove`/`verify` are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from ..fields import tower
from . import fri as fri_mod


@dataclasses.dataclass(frozen=True)
class CommitMeta:
    """n_multilins_by_vars[k] = number of committed (packed) multilinears
    with k variables."""

    n_multilins_by_vars: tuple

    @property
    def total_multilins(self) -> int:
        return sum(self.n_multilins_by_vars)

    @property
    def total_elems(self) -> int:
        return sum(c << k for k, c in enumerate(self.n_multilins_by_vars))

    @property
    def total_vars(self) -> int:
        return max((self.total_elems - 1).bit_length(), 0)

    @property
    def max_n_vars(self) -> int:
        return len(self.n_multilins_by_vars) - 1


def pack_multilinear(level: int, data: torch.Tensor, n_vars: int):
    """Small-field multilinear -> packed B128 multilinear; each B128 element
    packs 2^(7-level) consecutive coefficients. Returns (packed, packed_n_vars).

    `level` may be `tower.P1`: bit-packed B1 words are already the B128 limb
    layout, so packing is a view (the prover's commit at
    `constraint_system/prove.py:305-308`)."""
    if level == tower.P1:
        return data.reshape(-1, tower.n_limbs(7)), n_vars - 7
    log_deg = 7 - level
    if n_vars < log_deg:
        # fewer coefficients than one packed element: repeat to fill
        data = torch.cat([data] * (1 << (log_deg - n_vars)), dim=0)
    coeffs = data.reshape(tower.elem_shape(level, (-1, 1 << log_deg)))
    return tower.join_from_subfield(7, level, coeffs), max(n_vars - log_deg, 0)


def _bit_reverse_perm(n_vars: int) -> np.ndarray:
    idx = np.arange(1 << n_vars, dtype=np.int64)
    out = np.zeros_like(idx)
    for b in range(n_vars):
        out |= ((idx >> b) & 1) << (n_vars - 1 - b)
    return out


_DEV_PERMS: dict = {}


def _bit_reverse_perm_on(n_vars: int, device) -> torch.Tensor:
    key = (n_vars, str(device))
    if key not in _DEV_PERMS:
        _DEV_PERMS[key] = torch.from_numpy(_bit_reverse_perm(n_vars)).to(device)
    return _DEV_PERMS[key]


def merge_multilins(pieces: list, total_vars: int) -> torch.Tensor:
    """pieces: [(data, n_vars)] B128 tensors on one device, ascending by
    n_vars -> the merged message (2^total_vars, 4)."""
    device = pieces[0][0].device
    chunks = [data[_bit_reverse_perm_on(n_vars, device)] for data, n_vars in reversed(pieces)]
    pad = (1 << total_vars) - sum(1 << n for _, n in pieces)
    if pad:
        chunks.append(tower.zeros(7, (pad,), device=device))
    return torch.cat(chunks, dim=0)


def make_commit_params(commit_meta: CommitMeta, security_bits: int,
                       log_inv_rate: int) -> fri_mod.FRIParams:
    """FRI params with estimated optimal arity (`piop/verify.rs:137-160`)."""
    log_len = commit_meta.total_vars + log_inv_rate
    arity = fri_mod.estimate_optimal_arity(log_len, 32, 16)
    return fri_mod.FRIParams.choose_with_constant_fold_arity(
        commit_meta.total_vars, security_bits, log_inv_rate, arity)


def commit(fri_params: fri_mod.FRIParams, commit_meta: CommitMeta, packed_mles: list,
           device=None):
    """packed_mles: [(data, n_vars)] ascending by n_vars. Runs on CUDA unless
    `device` names another. Returns (codeword, tree, message)."""
    dev = resolve(device)
    message = merge_multilins([(d.to(dev), n) for d, n in packed_mles], commit_meta.total_vars)
    cw, tree = fri_mod.fri_commit(fri_params, message, dev)
    return cw, tree, message

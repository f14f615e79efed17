"""Carry state between the JAX package and the port.

The JAX package holds words as uint32 numpy/JAX arrays; the port holds the
same bits as ``torch.int32``. `from_reference` and `to_reference` cross
over with the bits unchanged, whatever the shape: P1 words, (N, 4) B128
limbs, (N, 8) digests. Evaluation claims and FRI parameters cross as plain
ints; proofs are plain `bytes` in both packages.

`ints_to_pairs` and `pairs_to_ints` cross between Python-int field elements
and the (n, 2) little-endian uint64 pairs that the native host library
(`native/`) reads and writes.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve
from .utils import tracing


def from_reference(arr: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with identical bits on `device`
    (CUDA unless named)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint32:
        raise TypeError(f"expected uint32, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(resolve(device))


def to_reference(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with identical bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected torch.int32, got {t.dtype}")
    tracing.count("readbacks")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


_M64 = (1 << 64) - 1


def ints_to_pairs(elems) -> np.ndarray:
    """B128 elements as ints -> (n, 2) uint64 (low word, high word)."""
    return np.array([(e & _M64, e >> 64) for e in elems], dtype=np.uint64).reshape(-1, 2)


def pairs_to_ints(m: np.ndarray) -> list[int]:
    """(n, 2) uint64 pairs -> ints."""
    return [lo | (hi << 64) for lo, hi in m.tolist()]


# ---------------------------------------------------------------------------
# Protocol objects (duck-typed: the port never imports the JAX package)
# ---------------------------------------------------------------------------

def claims_from_reference(claims) -> list:
    """The JAX package's `RingSwitchEvalClaim`s -> the port's (committed
    index, level, point, value)."""
    from .protocols.ring_switch import RingSwitchEvalClaim
    return [RingSwitchEvalClaim(int(c.committed_idx), int(c.level),
                                tuple(int(x) for x in c.point), int(c.eval)) for c in claims]


def fri_params_from_reference(p):
    """The JAX package's `FRIParams` -> the port's."""
    from .protocols.fri import FRIParams
    return FRIParams(int(p.log_dim), int(p.log_inv_rate), int(p.log_batch_size),
                     tuple(int(a) for a in p.fold_arities), int(p.n_test_queries))


def witness_from_reference(witness: dict, device=None) -> dict:
    """The JAX package's witness (oracle id -> (level, uint32 array)) -> the
    port's (oracle id -> (level, int32 tensor)) with the same bits and
    levels (bit-packed B1 columns stay packed: `tower.P1` is -1 in both)."""
    return {int(oid): (int(lvl), from_reference(np.asarray(data), device))
            for oid, (lvl, data) in witness.items()}

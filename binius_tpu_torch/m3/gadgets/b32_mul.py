"""The B32 multiplication circuit of `examples/b32_mul.py`.

A hand-built constraint system (no M3 table): three committed B32
oracles a, b, c of 2^log_n values and one zero constraint A*B + C = 0, so
that c holds the products a*b. The witness's product column is computed on
the device by `tower.mul` (one K1 launch on the card).
"""

from __future__ import annotations

import numpy as np

from ...constraint_system import oracle as om
from ...constraint_system.system import ConstraintSet, ConstraintSystem
from ...device import resolve
from ...fields import tower
from ...math.arith import ArithExpr


def b32_mul_inputs(log_n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """2^log_n random B32 pairs (a, b) drawn from numpy's
    `default_rng(seed)`, a then b, as `examples/b32_mul.py` draws them."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, size=1 << log_n, dtype=np.uint32)
    b = rng.integers(0, 1 << 32, size=1 << log_n, dtype=np.uint32)
    return a, b


def b32_mul_system(log_n: int) -> ConstraintSystem:
    oracles = om.OracleSet()
    ids = [oracles.add_committed(log_n, 5, name) for name in ("a", "b", "c")]
    A, B, C = (ArithExpr.var(i) for i in range(3))
    return ConstraintSystem(oracles, [ConstraintSet(log_n, tuple(ids), (A * B + C,))])


def b32_mul_witness(system: ConstraintSystem, a: np.ndarray, b: np.ndarray,
                    device=None) -> dict:
    """The witness on `device` (CUDA unless named): a and b as given, c =
    a * b computed there."""
    dev = resolve(device)
    a_id, b_id, c_id = system.constraint_sets[0].oracle_ids
    at, bt = tower.from_numpy(5, a, dev), tower.from_numpy(5, b, dev)
    return {a_id: (5, at), b_id: (5, bt), c_id: (5, tower.mul(5, at, bt))}

"""Fold helpers: bind one sumcheck or FRI variable to a challenge.

The part of `binius_tpu/math/fold.py` that the PIOP prover and FRI reach.
"""

from __future__ import annotations

import torch

from ..fields import tower


def extrapolate_line(level: int, x0: torch.Tensor, x1: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
    """x0 + (x1 + x0) * z, element-wise (z broadcasts)."""
    return x0 ^ tower.mul(level, x0 ^ x1, z)

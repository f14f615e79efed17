"""Explicit-collective helpers over a sharded hypercube.

The port of `binius_tpu/parallel/sharding.py`: the pattern the port's mesh is
built from. A B128 multilinear is sharded in contiguous blocks of its
element axis (the high variables pick the rank); folding the LOW variable
pairs adjacent rows, so it stays rank-local, and only the final field sum
crosses ranks, as an all-gather and a local XOR (`mesh.xor_all_reduce`).
Each helper returns a function over `RowShard`s, as the JAX package's return
jitted `shard_map` functions.
"""

from __future__ import annotations

import torch

from ..fields import tower
from ..math import fold
from . import mesh as mesh_mod

LEVEL = 7
AXIS = mesh_mod.AXIS


def make_mesh(n_devices: int | None = None) -> mesh_mod.Mesh:
    return mesh_mod.make_mesh(n_devices)


def shard_multilinear(mesh: mesh_mod.Mesh, data: torch.Tensor):
    """Place a B128 multilinear with its high variables sharded over the mesh."""
    return mesh_mod.put_axis_sharded(mesh, data, 0, min_elems=1)


def _local_vars(mesh: mesh_mod.Mesh, log_n: int) -> int:
    return log_n - mesh.log_size


def sharded_bivariate_round_evals(mesh: mesh_mod.Mesh, log_n: int):
    """fn(a, b) -> (3, 4): the round values at X = 0, 1, 2 of the product sum
    of two sharded multilinears over the hypercube, folding the LOW
    variable (pairs are rank-local; the sum is one all-reduce)."""
    log_local = _local_vars(mesh, log_n)

    def round_evals(a, b) -> torch.Tensor:
        a_blk, b_blk = mesh_mod.block_of(mesh, a), mesh_mod.block_of(mesh, b)
        e0a, e1a = fold.evals_01(LEVEL, a_blk, log_local, False)
        e0b, e1b = fold.evals_01(LEVEL, b_blk, log_local, False)
        two = tower.full(LEVEL, (), 2, a_blk.device)
        partial = torch.stack([
            tower.xor_reduce(tower.mul(LEVEL, e0a, e0b), 0),
            tower.xor_reduce(tower.mul(LEVEL, e1a, e1b), 0),
            tower.xor_reduce(tower.mul(LEVEL, fold.extrapolate_line(LEVEL, e0a, e1a, two),
                                       fold.extrapolate_line(LEVEL, e0b, e1b, two)), 0)])
        return mesh_mod.xor_all_reduce(mesh, partial)

    return round_evals


def sharded_fold_low(mesh: mesh_mod.Mesh, log_n: int):
    """fn(data, r) folding the LOW variable rank-locally; the result stays
    sharded (each rank's half-size block)."""
    log_local = _local_vars(mesh, log_n)

    def fold_low(data, r: torch.Tensor):
        e0, e1 = fold.evals_01(LEVEL, mesh_mod.block_of(mesh, data), log_local, False)
        return mesh_mod.RowShard(fold.extrapolate_line(LEVEL, e0, e1, r), mesh)

    return fold_low


def sharded_xor_sum(mesh: mesh_mod.Mesh):
    """fn(x) -> (4,): the field sum of a sharded B128 vector (a local XOR
    reduction, then the all-reduce)."""

    def xor_sum(x) -> torch.Tensor:
        return mesh_mod.xor_all_reduce(mesh, tower.xor_reduce(mesh_mod.block_of(mesh, x), 0))

    return xor_sum

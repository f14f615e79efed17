"""Mesh placement for the sharded prover.

The port of `binius_tpu/parallel/mesh.py`. The JAX package shards the
element axis of every large multilinear over a 1-D device mesh and lets
GSPMD partition its kernels. Torch has no such partitioner, so the port is
SPMD over `torch.distributed`: every rank is a process that holds its own
block of each sharded tensor as a plain local tensor (a `RowShard`), runs
its kernels on it, and meets the other ranks only in this module's
collectives.

* `put_row_sharded` keeps the rank's contiguous block of rows when the row
  count is at least max(min_elems, ranks) and the ranks divide it, else the
  whole tensor (a replica), as the JAX package places its columns.
* A field sum over a sharded axis is `xor_all_reduce`: an all-gather of
  every rank's partial sums, then the port's `tower.xor_reduce`. NCCL has
  no bitwise reduction (and gloo's BXOR would tie the bytes to a backend),
  so one path serves both backends.
* A fold of the high variable pairs row i with row i + 2^(n-1), which sit on
  different ranks under contiguous blocks; `to_strided` lays a block out
  again (one all-to-all) so that the low log2(ranks) bits of the index pick
  the rank, after which those folds are rank-local.
* Under gloo with the tensors on a card (several ranks sharing one card),
  every collective stages its operands through host buffers: gloo has no
  all-to-all or send/recv on CUDA tensors. Only data moves; no computation
  leaves the card.

Field operations are exact and the transcript is computed on every rank from
the same values, so proofs are byte-equal at one rank and at N.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..device import resolve
from ..fields import tower
from ..utils import tracing

AXIS = "hypercube"

#: Element axes smaller than this replicate instead of sharding (per-rank
#: blocks would be degenerate and the collectives' latency would dominate).
MIN_SHARD_ELEMS = 1 << 10


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of the default process group, this rank's place in it and
    its device. A mesh of one rank shards nothing."""

    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def log_size(self) -> int:
        return self.size.bit_length() - 1

    @property
    def staged(self) -> bool:
        """Collectives go through host buffers (gloo on CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of every rank of the default process group
    (`distributed.initialize`), on the device `initialize` chose unless
    `device` names another; without a process group, or with n_devices 1,
    a mesh of this process alone (CUDA unless `device` names another)."""
    if not dist.is_initialized() or n_devices == 1:
        return Mesh(0, 1, resolve(device), "none")
    size = dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(f"make_mesh: {n_devices} devices asked of a group of {size}")
    if size & (size - 1):
        raise ValueError(f"make_mesh: {size} ranks is not a power of two")
    if device is None:
        from . import distributed
        dev = distributed.device()
    else:
        dev = resolve(device)
    return Mesh(dist.get_rank(), size, dev, dist.get_backend())


@dataclasses.dataclass(eq=False)
class RowShard:
    """This rank's part of a tensor sharded on `axis` over `mesh`: a
    contiguous block of rows (`strided` False: rank r holds rows
    [r L, (r + 1) L)), or every size-th row (`strided`: rank r holds rows
    j size + r)."""

    local: torch.Tensor
    mesh: Mesh
    axis: int = 0
    strided: bool = False
    whole: torch.Tensor | None = None    # the gathered tensor, once `pull_local` ran

    @property
    def shape(self) -> tuple:
        s = list(self.local.shape)
        s[self.axis] *= self.mesh.size
        return tuple(s)

    @property
    def device(self) -> torch.device:
        return self.local.device


def is_mesh_sharded(x) -> bool:
    """True if x is a rank's part of a tensor sharded over several ranks."""
    return isinstance(x, RowShard) and x.mesh.size > 1


def any_mesh_sharded(arrays) -> bool:
    return any(is_mesh_sharded(x) for x in arrays)


def mesh_of(x) -> Mesh | None:
    """The mesh `x` is sharded over, or None."""
    return x.mesh if isinstance(x, RowShard) else None


def is_cross_process(mesh: Mesh) -> bool:
    """True when the mesh spans other processes (every rank is one)."""
    return mesh.size > 1


def _shardable(mesh: Mesh, n: int, min_elems: int) -> bool:
    return mesh.size > 1 and n >= max(min_elems, mesh.size) and n % mesh.size == 0


def put_row_sharded(mesh: Mesh, level: int, data: torch.Tensor,
                    min_elems: int = MIN_SHARD_ELEMS):
    """Place a multilinear (its elements, or bit-packed words at
    `tower.P1`, on the leading axis): this rank's block of rows when the
    axis is large and divisible, else the whole tensor on the mesh's
    device."""
    n = tower.batch_shape(level, data)[0] if data.ndim else 1
    return put_axis_sharded(mesh, data, 0, min_elems) if data.ndim and _shardable(
        mesh, n, min_elems) else put_replicated(mesh, data)


def put_replicated(mesh: Mesh, data: torch.Tensor) -> torch.Tensor:
    return data.to(mesh.device)


def put_axis_sharded(mesh: Mesh, data: torch.Tensor, axis: int,
                     min_elems: int = MIN_SHARD_ELEMS):
    """Shard one axis of a tensor in contiguous blocks (the element axis of
    a grouped-claim stack, say); a replica when too small or not
    divisible."""
    n = data.shape[axis]
    if not _shardable(mesh, n, min_elems):
        return put_replicated(mesh, data)
    blk = n // mesh.size
    return RowShard(data.narrow(axis, mesh.rank * blk, blk).to(mesh.device).contiguous(),
                    mesh, axis)


def block_of(mesh: Mesh, x) -> torch.Tensor:
    """This rank's contiguous block of rows of `x`: a block `RowShard`'s own
    part, or a slice of a replica (no communication)."""
    if isinstance(x, RowShard):
        assert x.axis == 0 and not x.strided
        return x.local
    blk = x.shape[0] // mesh.size
    return x[mesh.rank * blk:(mesh.rank + 1) * blk]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _out(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` where the backend can send it."""
    if mesh.staged:
        tracing.count("readbacks")
        t = t.cpu()
    return t.contiguous()


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(size, *t.shape): every rank's `t`, in rank order."""
    if mesh.size == 1:
        return t[None]
    src = _out(mesh, t)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src)
    return torch.stack(parts).to(mesh.device)


def all_to_all(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t (size, ...): chunk j goes to rank j; returns (size, ...) with
    chunk j from rank j."""
    if mesh.size == 1:
        return t
    src = _out(mesh, t)
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src)
    return dst.to(mesh.device)


def exchange(mesh: Mesh, t: torch.Tensor, partner: int) -> torch.Tensor:
    """Swap `t` with rank `partner` (which calls this with this rank): one
    all-to-all that sends nothing to the other ranks."""
    src = _out(mesh, t).reshape(-1)
    splits = [src.numel() if r == partner else 0 for r in range(mesh.size)]
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src, splits, splits)
    return dst.reshape(t.shape).to(mesh.device)


def xor_all_reduce(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The field sum (XOR) of `t` over the ranks, on every rank."""
    if mesh.size == 1:
        return t
    return tower.xor_reduce(all_gather(mesh, t), 0)


def pull_local(x):
    """The whole tensor of a `RowShard` on every rank (an all-gather, kept
    for the next call); a tensor that is not sharded is returned as it
    is."""
    if not isinstance(x, RowShard):
        return x
    if x.whole is not None:
        return x.whole
    g = all_gather(x.mesh, x.local)                  # (size, ...)
    if x.strided:                                    # row j size + r from rank r
        g = g.movedim(0, x.axis + 1)
    else:
        g = g.movedim(0, x.axis)
    x.whole = g.reshape(x.shape)
    return x.whole


def to_strided(mesh: Mesh, block: torch.Tensor, axis: int) -> RowShard:
    """Lay this rank's contiguous block of `axis` out again so that rank r
    holds the rows j size + r: one all-to-all. The block's rows must be a
    multiple of the ranks."""
    n, size = block.shape[axis], mesh.size
    assert n % size == 0
    parts = block.unflatten(axis, (n // size, size)).movedim(axis + 1, 0)
    got = all_to_all(mesh, parts)          # got[s]: rank s's rows with index = rank mod size
    return RowShard(got.movedim(0, axis).flatten(axis, axis + 1).contiguous(),
                    mesh, axis, strided=True)

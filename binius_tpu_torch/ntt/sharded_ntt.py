"""The additive NTT over a mesh of ranks.

The port of `binius_tpu/ntt/sharded_ntt.py`. The data is sharded in
contiguous blocks of S elements (`parallel.mesh.RowShard`), so a butterfly
stage whose element distance is below S is rank-local and the at most
log2(ranks) stages above it pair whole blocks of two ranks:

  * a cross stage exchanges the block with rank `rank ^ D` (D = the stage's
    distance in blocks); its twiddle is one constant per rank there, so
    each side does one subfield scale and XORs: the u side x + t y, the v
    side x + y + t x (forward; the inverse likewise, its halves swapped);
  * the local stages are the block's own sub-transform with coset
    (coset << log2(ranks)) | rank and log2(ranks) more coset bits, run by
    the port's `AdditiveNTT` (on the card K2, K3 and K4 wherever
    `bitsliced_ntt.supported` takes the block, the stage loop elsewhere).

Forward runs the cross stages first, the inverse last. The JAX package's
`lax.cond` on the shard index is a branch on the rank here.
"""

from __future__ import annotations

import torch

from ..fields import tower
from ..parallel import mesh as mesh_mod


def suitable(ntt, data, shape, mesh) -> bool:
    """The sharded transform applies: a mesh of 2^k > 1 ranks, no Z batch,
    twiddles at B32 or below, and at least one X row pair per rank."""
    log_x, log_y, log_z = shape
    if mesh is None or log_z != 0 or ntt.level > 5:
        return False
    n_dev = mesh.size
    if n_dev & (n_dev - 1) or n_dev < 2:
        return False
    if isinstance(data, mesh_mod.RowShard) and (data.axis != 0 or data.strided):
        return False
    return log_y - mesh.log_size >= 1


def transform_sharded(ntt, data, data_level: int, shape: tuple, coset: int,
                      coset_bits: int, skip_rounds: int, inverse: bool, mesh):
    """The transform of a row-sharded `data` (a `RowShard`, or a replica of
    which this rank takes its block); returns this rank's block of the
    result as a `RowShard`."""
    log_x, log_y, _ = shape
    tl, dl, dom = ntt.level, data_level, ntt.domain
    log_dev, s = mesh.log_size, mesh.rank
    S = 1 << (log_x + log_y - log_dev)
    log_yp = log_y - log_dev
    stage_is = (range(0, log_y - skip_rounds) if inverse
                else range(log_y - skip_rounds - 1, -1, -1))
    cross_is = [i for i in stage_is if (1 << (i + log_x)) >= S]
    base_round = dom.log_domain_size - (log_y + coset_bits)
    assert base_round >= 0, "domain too small"
    x = mesh_mod.block_of(mesh, data)

    def cross_stage(i: int, x: torch.Tensor) -> torch.Tensor:
        D = (1 << (i + log_x)) // S
        other = mesh_mod.exchange(mesh, x, s ^ D)
        n_bits = log_y - 1 - i
        j = ((s * S) >> (i + 1 + log_x)) & ((1 << n_bits) - 1)
        t = tower.full(tl, (), dom.twiddle(base_round + i, (coset << n_bits) | j), x.device)

        def scale(v):
            return tower.scale_subfield(tl, dl, t, v)

        # each rank runs one branch: one subfield scale per element, as the
        # one-device stage spends per pair
        if s & D == 0:
            return x ^ (scale(x ^ other) if inverse else scale(other))
        return x ^ other if inverse else x ^ other ^ scale(x)

    def run_local(x: torch.Tensor) -> torch.Tensor:
        skip_local = max(0, skip_rounds - log_dev)
        if log_yp - skip_local <= 0:
            return x
        fn = ntt.inverse if inverse else ntt.forward
        return fn(x, dl, (log_x, log_yp, 0), coset=(coset << log_dev) | s,
                  coset_bits=coset_bits + log_dev, skip_rounds=skip_local, device=x.device)

    if inverse:
        x = run_local(x)
        for i in cross_is:
            x = cross_stage(i, x)
    else:
        for i in cross_is:
            x = cross_stage(i, x)
        x = run_local(x)
    return mesh_mod.RowShard(x, mesh)

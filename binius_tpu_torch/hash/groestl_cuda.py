"""K5 and K6: Grøstl-256 Merkle leaves and levels on the card.

Counterpart of `binius_tpu/hash/groestl_pallas.py` (`leaf_hash_kernel`,
`pairs_kernel`, `tree_levels`). Output contract as there: (n, 8) int32
digests, word j = digest bytes 4j..4j+3 little-endian. The kernels
(`csrc/groestl.cu`) run the T-table permutation over one table: K5 one
thread per leaf or, below `LANES_BELOW` leaves, 16 cooperating lanes per
leaf; K6 one launch per wide level (one thread per pair) and one
cooperative launch (8 lanes per pair) for the levels of at most
`TAIL_PAIRS` pairs up to the root. `tree_levels` builds every layer of a
tree into one buffer. On a CPU tensor each wrapper takes the plain
version in `groestl`; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_lib
from . import groestl

# K5 runs 16 lanes per leaf (`leaf_lanes_kernel`) below this many leaves and
# one thread per leaf (`leaf_kernel`) from it on: lane groups shorten each
# leaf's chain and spread few leaves over the card, one thread per leaf
# spends the fewest lookups per leaf (times of both at the opening's four
# shapes in PERF.md).
LANES_BELOW = 1 << 13
# K6 runs the levels of at most this many pairs, and every level above
# them, in one cooperative launch (`tail_kernel`, 8 lanes per pair); each
# wider level is one launch (`pairs_kernel`, one thread per pair, which
# spends the fewest lookups per pair but below 2^15 pairs costs a chain's
# latency per launch). Picked from the trees' times at every power of two
# at the opening's four tree shapes (PERF.md).
TAIL_PAIRS = 1 << 15

_TABLES: dict = {}


def _tables(device) -> torch.Tensor:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(groestl.kernel_tables_np().view(np.int64)).to(device)
    return _TABLES[key]


def _bytes_view(t: torch.Tensor, row_bytes: int) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(-1, row_bytes)


def leaf_hash_plain(cw: torch.Tensor, log_coset: int, blob_len: int) -> torch.Tensor:
    """Plain version of K5: (N_elems, limbs) int32 -> (n_leaves, 8) int32."""
    return groestl.leaf_hash_t(_bytes_view(cw, blob_len)).contiguous().view(torch.int32)


def pairs_plain(digests: torch.Tensor) -> torch.Tensor:
    """Plain version of K6's wide level: (2n, 8) int32 -> (n, 8) int32."""
    return groestl.compress_pairs_t(_bytes_view(digests, 64)).contiguous().view(torch.int32)


def tail_plain(digests: torch.Tensor) -> torch.Tensor:
    """Plain version of K6's tail: (2n, 8) int32 digests, n a power of two ->
    the n, n/2, ..., 1 digests of every level above them, stacked (2n - 1, 8)."""
    levels = [pairs_plain(digests)]
    while levels[-1].shape[0] > 1:
        levels.append(pairs_plain(levels[-1]))
    return torch.cat(levels)


def leaf_hash_kernel(cw: torch.Tensor, log_coset: int, blob_len: int,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Grøstl-256 of each leaf of a codeword: leaves are 2^log_coset
    consecutive elements (blob_len bytes, limbs little-endian). Written
    into `out` ((n_leaves, 8) int32) where given."""
    n_leaves = cw.shape[0] >> log_coset
    if out is None:
        out = torch.empty((n_leaves, 8), dtype=torch.int32, device=cw.device)
    if not cw.is_cuda:
        out.copy_(leaf_hash_plain(cw, log_coset, blob_len))
        return out
    cuda_lib.check(cw, "leaf_hash_kernel", ndim=2)
    cuda_lib.check(out, "leaf_hash_kernel out", ndim=2)
    if (blob_len % 8 or n_leaves << log_coset != cw.shape[0]
            or blob_len != (cw.numel() * 4) // n_leaves):
        raise ValueError(f"leaf_hash_kernel: codeword {tuple(cw.shape)} does not split "
                         f"into 2^{log_coset}-element leaves of {blob_len} bytes")
    if tuple(out.shape) != (n_leaves, 8):
        raise ValueError(f"leaf_hash_kernel: out {tuple(out.shape)} is not ({n_leaves}, 8)")
    cuda_lib.call("k5_groestl_leaf", cw.data_ptr(), n_leaves, blob_len // 8,
                  _tables(cw.device).data_ptr(), out.data_ptr(), int(n_leaves < LANES_BELOW))
    return out


def _check_pairs(digests: torch.Tensor, out: torch.Tensor, rows: int, name: str) -> None:
    cuda_lib.check(digests, name, ndim=2)
    cuda_lib.check(out, f"{name} out", ndim=2)
    if digests.shape[1] != 8 or digests.shape[0] % 2:
        raise ValueError(f"{name}: expected (2n, 8) digests, got {tuple(digests.shape)}")
    if tuple(out.shape) != (rows, 8):
        raise ValueError(f"{name}: out {tuple(out.shape)} is not ({rows}, 8)")


def pairs_kernel(digests: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """One Merkle level (K6, wide): (2n, 8) int32 digests -> (n, 8), written
    into `out` where given."""
    n = digests.shape[0] // 2
    if out is None:
        out = torch.empty((n, 8), dtype=torch.int32, device=digests.device)
    if not digests.is_cuda:
        out.copy_(pairs_plain(digests))
        return out
    _check_pairs(digests, out, n, "pairs_kernel")
    cuda_lib.call("k6_groestl_pairs", digests.data_ptr(), n,
                  _tables(digests.device).data_ptr(), out.data_ptr(), 0)
    return out


def tail_kernel(digests: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Every Merkle level above (2n, 8) int32 digests, n a power of two, to
    the root in one launch (K6, tail): the n, n/2, ..., 1 digests stacked
    (2n - 1, 8), written into `out` where given."""
    n = digests.shape[0] // 2
    if n < 1 or n & (n - 1):
        raise ValueError(f"tail_kernel: {digests.shape[0]} digests are not 2^k, k >= 1")
    if out is None:
        out = torch.empty((2 * n - 1, 8), dtype=torch.int32, device=digests.device)
    if not digests.is_cuda:
        out.copy_(tail_plain(digests))
        return out
    _check_pairs(digests, out, 2 * n - 1, "tail_kernel")
    cuda_lib.call("k6_groestl_pairs", digests.data_ptr(), n,
                  _tables(digests.device).data_ptr(), out.data_ptr(), 1)
    return out


def tree_launches(n_leaves: int) -> list:
    """K6's launches for a tree of n_leaves (a power of two) leaves, leaf-up:
    ("pairs" | "tail", first row of the input layer in the stacked buffer,
    pairs of that layer). Wide levels one each, then one tail for the
    levels of at most `TAIL_PAIRS` pairs and all above them."""
    out, row, rows = [], 0, n_leaves
    while rows > 1:
        if rows // 2 <= TAIL_PAIRS:
            out.append(("tail", row, rows // 2))
            break
        out.append(("pairs", row, rows // 2))
        row, rows = row + rows, rows // 2
    return out


def tree_levels(cw: torch.Tensor, log_coset: int, blob_len: int) -> torch.Tensor:
    """Every layer of the Merkle tree of a codeword, leaf to root, stacked in
    one (2N - 1, 8) int32 buffer on the codeword's device (N leaves, a power
    of two): K5 writes the leaves, then `pair_levels` every level above
    them, queued on one stream with no host synchronisation."""
    n_leaves = cw.shape[0] >> log_coset
    if n_leaves < 1 or n_leaves & (n_leaves - 1):
        raise ValueError(f"tree_levels: {n_leaves} leaves is not a power of two")
    buf = torch.empty((2 * n_leaves - 1, 8), dtype=torch.int32, device=cw.device)
    leaf_hash_kernel(cw, log_coset, blob_len, out=buf[:n_leaves])
    return pair_levels(buf)


def pair_levels(buf: torch.Tensor) -> torch.Tensor:
    """Every level of a stacked tree buffer ((2N - 1, 8), the N leaves first)
    above its leaves, through K6's launches (`tree_launches`)."""
    for kind, row, n in tree_launches((buf.shape[0] + 1) // 2):
        if kind == "tail":
            tail_kernel(buf[row:row + 2 * n], out=buf[row + 2 * n:])
        else:
            pairs_kernel(buf[row:row + 2 * n], out=buf[row + 2 * n:row + 3 * n])
    return buf


def split_layers(buf):
    """The layers of a stacked tree buffer ((2N - 1, ...) rows, leaves
    first; a tensor or a numpy array), leaf to root, as views."""
    layers, row, rows = [], 0, (buf.shape[0] + 1) // 2
    while True:
        layers.append(buf[row:row + rows])
        if rows == 1:
            return layers
        row, rows = row + rows, rows // 2

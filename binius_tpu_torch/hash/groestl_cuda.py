"""K5 and K6: Grøstl-256 Merkle leaves and levels on the card.

Counterpart of `binius_tpu/hash/groestl_pallas.py` (`leaf_hash_kernel`,
`pairs_kernel`, `tree_levels`). Output contract as there: (n, 8) int32
digests, word j = digest bytes 4j..4j+3 little-endian. The kernels
(`csrc/groestl.cu`) run the T-table permutation: K6 one thread per pair,
K5 one thread per leaf or, below `LANES_BELOW` leaves, 16 cooperating
lanes per leaf. On a CPU tensor each wrapper takes the plain version in
`groestl`; on a CUDA tensor it launches its kernel or raises.
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
    """Plain version of K6: (2n, 8) int32 -> (n, 8) int32."""
    return groestl.compress_pairs_t(_bytes_view(digests, 64)).contiguous().view(torch.int32)


def leaf_hash_kernel(cw: torch.Tensor, log_coset: int, blob_len: int) -> torch.Tensor:
    """Grøstl-256 of each leaf of a codeword: leaves are 2^log_coset
    consecutive elements (blob_len bytes, limbs little-endian)."""
    if not cw.is_cuda:
        return leaf_hash_plain(cw, log_coset, blob_len)
    cuda_lib.check(cw, "leaf_hash_kernel", ndim=2)
    n_leaves = cw.shape[0] >> log_coset
    if (blob_len % 8 or n_leaves << log_coset != cw.shape[0]
            or blob_len != (cw.numel() * 4) // n_leaves):
        raise ValueError(f"leaf_hash_kernel: codeword {tuple(cw.shape)} does not split "
                         f"into 2^{log_coset}-element leaves of {blob_len} bytes")
    out = torch.empty((n_leaves, 8), dtype=torch.int32, device=cw.device)
    cuda_lib.call("k5_groestl_leaf", cw.data_ptr(), n_leaves, blob_len // 8,
                  _tables(cw.device).data_ptr(), out.data_ptr(), int(n_leaves < LANES_BELOW))
    return out


def pairs_kernel(digests: torch.Tensor) -> torch.Tensor:
    """One Merkle level: (2n, 8) int32 digests -> (n, 8)."""
    if not digests.is_cuda:
        return pairs_plain(digests)
    cuda_lib.check(digests, "pairs_kernel", ndim=2)
    if digests.shape[1] != 8 or digests.shape[0] % 2:
        raise ValueError(f"pairs_kernel: expected (2n, 8) digests, got {tuple(digests.shape)}")
    n = digests.shape[0] // 2
    out = torch.empty((n, 8), dtype=torch.int32, device=digests.device)
    cuda_lib.call("k6_groestl_pairs", digests.data_ptr(), n,
                  _tables(digests.device).data_ptr(), out.data_ptr())
    return out


def tree_levels(cw: torch.Tensor, log_coset: int, blob_len: int, n_dev: int) -> list:
    """Leaf digests plus `n_dev` 2-to-1 levels, leaf-up, queued on one stream
    with no host synchronisation."""
    outs = [leaf_hash_kernel(cw, log_coset, blob_len)]
    for _ in range(n_dev):
        outs.append(pairs_kernel(outs[-1]))
    return outs

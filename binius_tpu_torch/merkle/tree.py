"""Binary Merkle tree vector commitment over Grøstl-256.

Counterpart of `binius_tpu/merkle/tree.py`: leaves are byte blobs
(canonically serialized field elements) hashed with Grøstl-256; internal
nodes use the output-transform 2-to-1 compression. `MerkleTree` is the host
tree (numpy layers); `commit_codeword_device` builds the wide levels on the
codeword's device (K5 and K6 on the card) and only the
`_MIN_DEVICE_ROWS`-row layer crosses to the host, which builds the top.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from ..hash import groestl, groestl_cuda

# device levels stop once a layer is this small; the top of the tree is
# latency-bound and runs on the host
_MIN_DEVICE_ROWS = 256


def hash_leaves(blobs: np.ndarray) -> np.ndarray:
    """Grøstl-256 digest of each row on the host: (N, L) uint8 -> (N, 32) uint8."""
    return groestl.hash_leaves_np(blobs)


@dataclasses.dataclass
class MerkleTree:
    """All layers, layer[0] = leaf digests (N, 32) ... layer[d] = root (1, 32)."""

    layers: list

    @staticmethod
    def build(leaf_digests: np.ndarray) -> "MerkleTree":
        assert leaf_digests.ndim == 2 and leaf_digests.shape[1] == 32
        n = leaf_digests.shape[0]
        assert n & (n - 1) == 0, "leaf count must be a power of two"
        layers = [np.ascontiguousarray(leaf_digests)]
        while layers[-1].shape[0] > 1:
            layers.append(np.ascontiguousarray(groestl.compress_pairs(layers[-1].reshape(-1, 64))))
        return MerkleTree(layers)

    @property
    def root(self) -> bytes:
        return self.layers[-1][0].tobytes()

    @property
    def depth(self) -> int:
        return len(self.layers) - 1

    def branch(self, index: int, to_layer: int = None) -> list[bytes]:
        """Sibling digests from the leaf up (exclusive of `to_layer`, default root)."""
        d = self.depth if to_layer is None else to_layer
        return [self.layers[k][(index >> k) ^ 1].tobytes() for k in range(d)]

    def layer_np(self, k: int) -> np.ndarray:
        return self.layers[k]

    def branches_many(self, indices: list[int], to_layer: int) -> list[list[bytes]]:
        return [self.branch(i, to_layer) for i in indices]


def verify_branch(root: bytes, index: int, leaf_digest: bytes, branch: list[bytes]) -> bool:
    cur = np.frombuffer(leaf_digest, dtype=np.uint8)
    for k, sib in enumerate(branch):
        s = np.frombuffer(sib, dtype=np.uint8)
        pair = np.concatenate([cur, s] if ((index >> k) & 1) == 0 else [s, cur])
        cur = groestl.compress_pairs(pair[None, :])[0]
    return cur.tobytes() == root


def _digests_to_np(dig: torch.Tensor) -> np.ndarray:
    """(N, 8) int32 digests -> (N, 32) uint8 host rows."""
    return dig.detach().cpu().contiguous().numpy().view(np.uint8).reshape(-1, 32)


def commit_codeword_device(codeword: torch.Tensor, log_coset: int,
                           device=None) -> "DeviceMerkleTree":
    """Merkle tree of a codeword ((N, limbs) int32) on CUDA unless `device`
    names another: leaf hashing and the wide levels through K5/K6 (their
    plain versions on the CPU), the top <= `_MIN_DEVICE_ROWS` rows on the
    host."""
    cw = codeword.to(resolve(device)).reshape(codeword.shape[0], -1).contiguous()
    n_leaves = cw.shape[0] >> log_coset
    blob_len = cw.numel() * 4 // max(n_leaves, 1)
    n_dev = max(0, (n_leaves.bit_length() - 1) - (_MIN_DEVICE_ROWS.bit_length() - 1))
    outs = groestl_cuda.tree_levels(cw, log_coset, blob_len, n_dev)
    top = MerkleTree.build(_digests_to_np(outs[-1]))
    return DeviceMerkleTree(outs[:-1], top)


class DeviceMerkleTree:
    """Merkle tree whose wide levels stay on the device ((N, 8) int32 digests)
    and whose top (<= `_MIN_DEVICE_ROWS` rows) is a host `MerkleTree`."""

    def __init__(self, dev_layers: list, top: MerkleTree):
        self.dev_layers = dev_layers      # leaf-up
        self.top = top
        self._layer_cache: dict[int, np.ndarray] = {}

    @property
    def root(self) -> bytes:
        return self.top.root

    @property
    def depth(self) -> int:
        return len(self.dev_layers) + self.top.depth

    def layer_np(self, k: int) -> np.ndarray:
        """Layer k (leaf = 0) as (N, 32) uint8 host rows."""
        n_dev = len(self.dev_layers)
        if k >= n_dev:
            return self.top.layers[k - n_dev]
        if k not in self._layer_cache:
            self._layer_cache[k] = _digests_to_np(self.dev_layers[k])
        return self._layer_cache[k]

    def branches_many(self, indices: list[int], to_layer: int) -> list[list[bytes]]:
        """Sibling paths for many leaves: the sibling rows of every device
        layer are gathered on the device and cross to the host in one copy."""
        n_dev = min(len(self.dev_layers), to_layer)
        out = [[] for _ in indices]
        if n_dev:
            dev = self.dev_layers[0].device
            rows = _digests_to_np(torch.cat([
                self.dev_layers[k][torch.tensor([(i >> k) ^ 1 for i in indices], device=dev)]
                for k in range(n_dev)]))
            for k in range(n_dev):
                for q in range(len(indices)):
                    out[q].append(rows[k * len(indices) + q].tobytes())
        for k in range(n_dev, to_layer):
            layer = self.layer_np(k)
            for q, i in enumerate(indices):
                out[q].append(layer[(i >> k) ^ 1].tobytes())
        return out

    def branch(self, index: int, to_layer: int = None) -> list[bytes]:
        return self.branches_many([index], self.depth if to_layer is None else to_layer)[0]

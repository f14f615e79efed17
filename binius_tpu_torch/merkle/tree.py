"""Binary Merkle tree vector commitment over Grøstl-256 or Vision Mark-32.

Counterpart of `binius_tpu/merkle/tree.py`: leaves are byte blobs
(canonically serialized field elements) hashed with the scheme's digest;
internal nodes use its 2-to-1 compression (`merkle_tree/scheme.rs`: Grøstl-
256 with the output-transform compression, the default, or Vision Mark-32).
`MerkleTree` is the host tree (numpy layers, each level one batch of the
scheme's compression: Grøstl's leaves, levels and branch checks in the
native host library's C); `commit_codeword_device` builds every layer of a
Grøstl tree, leaf to root, on the codeword's device (K5 and K6 on the card)
and copies the top layers to the host in one copy. The prover hashes
nothing on the host. A codeword sharded over a mesh (`parallel.mesh.RowShard`)
is committed rank by rank: each rank hashes its leaves and its subtree,
the layers are gathered, and the N subtree roots are compressed to the root
(the JAX package commits a sharded codeword on the host); the queries read
the gathered layers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..device import resolve
from ..hash import groestl, groestl_cuda
from ..parallel import mesh as mesh_mod
from ..utils import tracing

# the layers of at most this many rows (the root among them) cross to the
# host in one copy when the tree is built: the root and the layers FRI
# writes whole into the proof are read from there
TOP_COPY_ROWS = 256


def hash_leaves(blobs: np.ndarray) -> np.ndarray:
    """Grøstl-256 digest of each row on the host: (N, L) uint8 -> (N, 32) uint8."""
    return groestl.hash_leaves_np(blobs)


@dataclasses.dataclass(frozen=True)
class HashScheme:
    """A Merkle digest family: batched leaf hashing and 2-to-1 compression
    (the reference's `MerkleTreeScheme` hash parameters, Grøstl-256 or
    Vision Mark-32, `merkle_tree/scheme.rs`)."""

    name: str
    hash_leaves: Callable      # (N, L) uint8 -> (N, 32) uint8
    compress_pairs: Callable   # (N, 64) uint8 -> (N, 32) uint8


GROESTL_SCHEME = HashScheme("groestl256", hash_leaves, groestl.compress_pairs)


@functools.lru_cache(maxsize=None)
def vision_scheme(device=None) -> HashScheme:
    """Vision Mark-32 (`hash/vision.py`), its batches on CUDA unless
    `device` names another."""
    from ..hash import vision

    return HashScheme("vision32", functools.partial(vision.digest_many, device=device),
                      vision.Vision32Compression(device).compress_batch)


@dataclasses.dataclass
class MerkleTree:
    """All layers, layer[0] = leaf digests (N, 32) ... layer[d] = root (1, 32)."""

    layers: list
    scheme: HashScheme = GROESTL_SCHEME

    @staticmethod
    def build(leaf_digests: np.ndarray, scheme: HashScheme = GROESTL_SCHEME) -> "MerkleTree":
        assert leaf_digests.ndim == 2 and leaf_digests.shape[1] == 32
        n = leaf_digests.shape[0]
        assert n & (n - 1) == 0, "leaf count must be a power of two"
        layers = [np.ascontiguousarray(leaf_digests)]
        while layers[-1].shape[0] > 1:
            layers.append(np.ascontiguousarray(
                scheme.compress_pairs(layers[-1].reshape(-1, 64))))
        return MerkleTree(layers, scheme)

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


def _branch_top(index: int, leaf_digest: bytes, branch: list[bytes],
                scheme: HashScheme) -> bytes:
    """The digest that the leaf and its sibling path hash up to."""
    cur = np.frombuffer(leaf_digest, dtype=np.uint8)
    for k, sib in enumerate(branch):
        s = np.frombuffer(sib, dtype=np.uint8)
        pair = np.concatenate([cur, s] if ((index >> k) & 1) == 0 else [s, cur])
        cur = np.asarray(scheme.compress_pairs(pair[None, :]))[0]
    return cur.tobytes()


def verify_branch(root: bytes, index: int, leaf_digest: bytes, branch: list[bytes],
                  scheme: HashScheme = GROESTL_SCHEME) -> bool:
    return _branch_top(index, leaf_digest, branch, scheme) == root


def verify_branch_to_layer(layer: np.ndarray, index: int, leaf_digest: bytes,
                           branch: list[bytes], scheme: HashScheme = GROESTL_SCHEME) -> bool:
    """Verify against a cached internal layer (the reference's optimal
    verification layer, `merkle_tree/scheme.rs:48-50`)."""
    return (_branch_top(index, leaf_digest, branch, scheme)
            == layer[index >> len(branch)].tobytes())


def _digests_to_np(dig: torch.Tensor) -> np.ndarray:
    """(N, 8) int32 digests -> (N, 32) uint8 host rows."""
    tracing.count("readbacks")
    return dig.detach().cpu().contiguous().numpy().view(np.uint8).reshape(-1, 32)


def commit_codeword_device(codeword: torch.Tensor, log_coset: int,
                           device=None) -> "DeviceMerkleTree":
    """Merkle tree of a codeword ((N, limbs) int32) on CUDA unless `device`
    names another: every layer through K5 and K6 (their plain versions on
    the CPU), the top copied to the host once. A `RowShard` codeword is
    committed by its ranks (`_sharded_levels`) on the mesh's device where
    each rank's block holds whole leaves, else gathered and committed whole
    on every rank."""
    if isinstance(codeword, mesh_mod.RowShard):
        if codeword.local.shape[0] >> log_coset:
            return DeviceMerkleTree(_sharded_levels(codeword, log_coset))
        codeword = mesh_mod.pull_local(codeword)
    cw = codeword.to(resolve(device)).reshape(codeword.shape[0], -1).contiguous()
    n_leaves = cw.shape[0] >> log_coset
    blob_len = cw.numel() * 4 // max(n_leaves, 1)
    return DeviceMerkleTree(groestl_cuda.tree_levels(cw, log_coset, blob_len))


def _sharded_levels(codeword: "mesh_mod.RowShard", log_coset: int) -> torch.Tensor:
    """The stacked layers of a codeword sharded in blocks over N ranks: this
    rank's subtree (K5, K6), every rank's gathered layer by layer, then the
    top log2 N levels above the N subtree roots (K6)."""
    mesh = codeword.mesh
    cw = codeword.local.reshape(codeword.local.shape[0], -1).contiguous()
    n_leaves = cw.shape[0] >> log_coset
    buf = groestl_cuda.tree_levels(cw, log_coset, cw.numel() * 4 // max(n_leaves, 1))
    subtrees = mesh_mod.all_gather(mesh, buf)                 # (N, 2L - 1, 8)
    layers = [t.transpose(0, 1).reshape(-1, 8)                 # rank major
              for t in groestl_cuda.split_layers(subtrees.transpose(0, 1))]
    top = torch.empty((2 * mesh.size - 1, 8), dtype=buf.dtype, device=buf.device)
    top[:mesh.size] = layers[-1]
    groestl_cuda.pair_levels(top)
    return torch.cat(layers + [top[mesh.size:]])


class DeviceMerkleTree:
    """Merkle tree whose layers stay on the device, stacked leaf to root in
    one (2N - 1, 8) int32 buffer; the layers of at most `TOP_COPY_ROWS` rows
    are also on the host, from one copy."""

    def __init__(self, buf: torch.Tensor):
        self.layers = groestl_cuda.split_layers(buf)      # leaf-up, device views
        self.n_dev = next(k for k, layer in enumerate(self.layers)
                          if layer.shape[0] <= TOP_COPY_ROWS)
        # layers n_dev.. on the host: the buffer's last rows, themselves a
        # stacked tree
        top_rows = 2 * self.layers[self.n_dev].shape[0] - 1
        self.top = groestl_cuda.split_layers(_digests_to_np(buf[buf.shape[0] - top_rows:]))
        self._layer_cache: dict[int, np.ndarray] = {}

    @property
    def root(self) -> bytes:
        return self.top[-1][0].tobytes()

    @property
    def depth(self) -> int:
        return len(self.layers) - 1

    def layer_np(self, k: int) -> np.ndarray:
        """Layer k (leaf = 0) as (N, 32) uint8 host rows."""
        if k >= self.n_dev:
            return self.top[k - self.n_dev]
        if k not in self._layer_cache:
            self._layer_cache[k] = _digests_to_np(self.layers[k])
        return self._layer_cache[k]

    def branches_many(self, indices: list[int], to_layer: int) -> list[list[bytes]]:
        """Sibling paths for many leaves: the sibling rows of every layer below
        the top are gathered on the device and cross to the host in one copy."""
        n_dev = min(self.n_dev, to_layer)
        out = [[] for _ in indices]
        if n_dev:
            dev = self.layers[0].device
            rows = _digests_to_np(torch.cat([
                self.layers[k][torch.tensor([(i >> k) ^ 1 for i in indices], device=dev)]
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

"""The port's Vision Mark-32 (`binius_tpu_torch.hash.vision`) and its Merkle
scheme against the JAX package's host (Python-int) Vision: the reference's
golden digests, the derived constants, the batched permutation and digests
through K1's plain version on the CPU, and Vision trees with their branches.
Every comparison is exact. The JAX package's jitted Vision path is not
called: its compile alone takes 9-35 s on a CPU."""

import numpy as np
import pytest
import torch

from binius_tpu.hash import vision as jvision
from binius_tpu_torch.hash import vision
from binius_tpu_torch.merkle.tree import (MerkleTree, verify_branch, verify_branch_to_layer,
                                          vision_scheme)

torch.set_num_threads(1)  # the suite's test processes share the cores

CPU = "cpu"


def test_golden_vectors():
    """Byte-exact parity with the reference (`digest.rs:367-407`)."""
    assert vision.digest(bytes([0xDE, 0xAD, 0xBE, 0xEF])).hex() == \
        "8ed389809fabe91cead4786eb08e2d32647a9ac69143040de500e4465c72f173"
    long = (b"One part of the mysterious existence of Captain Nemo had been "
            b"unveiled and, if his identity had not been recognised, at least, "
            b"the nations united against him were no longer hunting a chimerical "
            b"creature, but a man who had vowed a deadly hatred against them")
    assert vision.digest(long).hex() == \
        "b615664d0249149b5655a86919169f0fd4b44fec83d4c43e4f1f124c3f9a82c3"
    unaligned = (b"You can prove anything you want by coldly logical reason--if "
                 b"you pick the proper postulates.")
    assert vision.digest(unaligned).hex() == \
        "0aa2879dcac953550ebe5d9da2a91d3c0356feca9044acf4edca87b28d9959e1"


def test_constants_match_reference():
    assert vision.ROUND_KEYS == jvision.ROUND_KEYS
    assert np.array_equal(vision._mds_matrix(), jvision._mds_matrix())
    for which in ("fwd", "inv"):
        assert vision._affine_canonical(which) == jvision._affine_canonical(which)
    rng = np.random.default_rng(1)
    state = [int(v) for v in rng.integers(0, 1 << 32, 24, dtype=np.uint64)]
    assert vision.permute_scalar(state) == jvision.permute_scalar(state)


def _rows(t: torch.Tensor) -> list[list[int]]:
    return t.numpy().view(np.uint32).astype(int).tolist()


def test_permute_batch_matches_scalar():
    """Random states and states with zero words (inversion keeps 0 -> 0)."""
    rng = np.random.default_rng(2)
    states = rng.integers(0, 1 << 32, (3, 24), dtype=np.uint64).astype(np.uint32)
    states[1, ::3] = 0
    states[2] = 0
    states[2, 5] = 7
    # the round-0 key makes a word zero where the state equals it
    states[0, 4] = vision.ROUND_KEYS[0][4]
    got = vision.permute_batch(torch.from_numpy(states.view(np.int32)), CPU)
    assert _rows(got) == [jvision.permute_scalar([int(v) for v in s]) for s in states]


@pytest.mark.parametrize("n,length", [(6, 130), (4, 256), (4, 64)])
def test_digest_many_matches_scalar(n, length):
    """One permutation batch per block; lengths that are a multiple of 64
    take a whole padding block."""
    msgs = np.random.default_rng(length).integers(0, 256, (n, length), dtype=np.uint8)
    got = vision.digest_many(msgs, CPU)
    assert got.shape == (n, 32) and got.dtype == np.uint8
    for i in range(n):
        assert bytes(got[i]) == jvision.digest(bytes(msgs[i]))


def test_streaming_chunks_match_oneshot():
    data = bytes(range(200))
    h = vision.VisionHasherDigest()
    h.update(data[:63]).update(data[63:128]).update(data[128:163]).update(data[163:])
    assert h.finalize() == vision.digest(data) == jvision.digest(data)
    assert vision.Vision32Compression().compress(data[:32], data[32:64]) == \
        jvision.digest(data[:64])


def _reference_tree(blobs: np.ndarray) -> list[list[bytes]]:
    """A Vision tree from the JAX package's scalar digest, layer by layer."""
    layers = [[jvision.digest(bytes(b)) for b in blobs]]
    while len(layers[-1]) > 1:
        prev = layers[-1]
        layers.append([jvision.digest(prev[2 * i] + prev[2 * i + 1])
                       for i in range(len(prev) // 2)])
    return layers


@pytest.fixture(scope="module")
def trees():
    """Vision trees of 8 leaves of 256 bytes (5 permutations a leaf) and of
    32 leaves of 48 bytes, built by the port on the CPU."""
    scheme = vision_scheme(CPU)
    out = {}
    for n_leaves, blob_len in ((8, 256), (32, 48)):
        blobs = np.random.default_rng(n_leaves).integers(0, 256, (n_leaves, blob_len),
                                                          dtype=np.uint8)
        out[n_leaves] = blobs, MerkleTree.build(scheme.hash_leaves(blobs), scheme)
    return out


@pytest.mark.parametrize("n_leaves", [8, 32])
def test_vision_tree_matches_reference(trees, n_leaves):
    blobs, tree = trees[n_leaves]
    want = _reference_tree(blobs)
    assert tree.scheme is vision_scheme(CPU) and tree.depth == len(want) - 1
    for layer, ref in zip(tree.layers, want):
        assert [bytes(r) for r in layer] == ref
    for i in (0, n_leaves - 3):
        assert tree.branch(i) == [want[k][(i >> k) ^ 1] for k in range(tree.depth)]


def test_verify_branch_under_vision(trees):
    scheme = vision_scheme(CPU)
    _, tree = trees[8]
    leaf = tree.layers[0][5].tobytes()
    assert verify_branch(tree.root, 5, leaf, tree.branch(5), scheme)
    bad = bytearray(leaf)
    bad[17] ^= 1
    assert not verify_branch(tree.root, 5, bytes(bad), tree.branch(5), scheme)
    # to the layer of 4 digests: one sibling
    layer = tree.layers[1]
    assert verify_branch_to_layer(layer, 2, tree.layers[0][2].tobytes(), tree.branch(2, 1),
                                  scheme)
    assert not verify_branch_to_layer(layer, 2, bytes(bad), tree.branch(2, 1), scheme)
    # the Grøstl default does not accept a Vision branch
    assert not verify_branch(tree.root, 5, leaf, tree.branch(5))

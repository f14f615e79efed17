"""binius_tpu_torch Merkle commit against the JAX package's host tree
(`MerkleTree.build(hash_leaves(leaf_blobs(...)))`), every layer, the
device tree's branch surface, and K6's split of a tree into wide levels
and one tail launch. Bit-exact. Codewords stay under 2^16 bytes, where the
reference hashes on the host without compiling a device kernel."""

import numpy as np
import pytest
import torch

from binius_tpu.merkle import tree as jtree
from binius_tpu.protocols import fri as jfri
from binius_tpu_torch.convert import from_reference
from binius_tpu_torch.hash import groestl_cuda
from binius_tpu_torch.merkle import tree
from binius_tpu_torch.protocols import fri

torch.set_num_threads(1)  # the suite's test processes share the cores


def _codeword(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 4), dtype=np.uint32)


@pytest.mark.parametrize("log_n,log_coset", [(6, 2), (11, 0), (11, 4), (5, 4)])
def test_root_matches_reference(log_n, log_coset):
    cw = _codeword(1 << log_n, seed=log_n)
    want = jtree.MerkleTree.build(jtree.hash_leaves(jfri.leaf_blobs(cw, log_coset)))
    dev_tree = tree.commit_codeword_device(from_reference(cw, "cpu"), log_coset, "cpu")
    assert dev_tree.root == want.root
    assert dev_tree.depth == want.depth
    assert fri.commit_codeword(cw, log_coset).root == want.root
    for k in range(want.depth + 1):
        assert np.array_equal(dev_tree.layer_np(k), want.layers[k])


def test_device_tree_keeps_wide_layers_and_opens_branches():
    cw = _codeword(1 << 11, seed=1)
    log_coset = 0
    dev_tree = tree.commit_codeword_device(from_reference(cw, "cpu"), log_coset, "cpu")
    n_leaves = cw.shape[0] >> log_coset
    # every layer a view of one stacked buffer, leaf to root; the top
    # layers, from TOP_COPY_ROWS rows up, also on the host
    assert [layer.shape[0] for layer in dev_tree.layers] == [n_leaves >> k for k in range(12)]
    base = dev_tree.layers[0]
    assert all(layer.data_ptr() == base.data_ptr() + (2 * n_leaves - 2 * layer.shape[0]) * 32
               for layer in dev_tree.layers)
    assert dev_tree.n_dev == (n_leaves // tree.TOP_COPY_ROWS).bit_length() - 1
    assert [t.shape[0] for t in dev_tree.top] == [tree.TOP_COPY_ROWS >> k for k in range(9)]
    leaves = dev_tree.layer_np(0)
    idx = [0, 5, n_leaves - 1]
    for i, br in zip(idx, dev_tree.branches_many(idx, dev_tree.depth)):
        assert tree.verify_branch(dev_tree.root, i, leaves[i].tobytes(), br)
    assert not tree.verify_branch(dev_tree.root, 1, leaves[0].tobytes(), dev_tree.branch(0))


@pytest.mark.parametrize("log_n", range(1, 20))
def test_tree_launches_cover_each_level_once_in_order(log_n):
    """K6's launches for 2^log_n leaves: wide levels above TAIL_PAIRS pairs
    one each, then one tail from there to the root, every level once."""
    n = 1 << log_n
    launches = groestl_cuda.tree_launches(n)
    want, row, rows = [], 0, n
    while rows > 1:
        want.append((row, rows // 2))
        row, rows = row + rows, rows // 2
    got = []
    for kind, row, pairs in launches:
        assert (kind == "tail") == (pairs <= groestl_cuda.TAIL_PAIRS)
        while pairs:
            got.append((row, pairs))
            row, pairs = row + 2 * pairs, (pairs // 2 if kind == "tail" else 0)
    assert got == want
    assert [kind for kind, _, _ in launches].count("tail") == 1 == (launches[-1][0] == "tail")

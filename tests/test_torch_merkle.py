"""binius_tpu_torch Merkle commit against the JAX package's host tree
(`MerkleTree.build(hash_leaves(leaf_blobs(...)))`), and the device tree's
branch surface. Bit-exact. Codewords stay under 2^16 bytes, where the
reference hashes on the host without compiling a device kernel."""

import numpy as np
import pytest

from binius_tpu.merkle import tree as jtree
from binius_tpu.protocols import fri as jfri
from binius_tpu_torch.convert import from_reference
from binius_tpu_torch.merkle import tree
from binius_tpu_torch.protocols import fri


def _codeword(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 4), dtype=np.uint32)


@pytest.mark.parametrize("log_n,log_coset", [(6, 2), (11, 0), (11, 4)])
def test_root_matches_reference(log_n, log_coset):
    cw = _codeword(1 << log_n, seed=log_n)
    want = jtree.MerkleTree.build(jtree.hash_leaves(jfri.leaf_blobs(cw, log_coset)))
    dev_tree = tree.commit_codeword_device(from_reference(cw, "cpu"), log_coset, "cpu")
    assert dev_tree.root == want.root
    assert dev_tree.depth == want.depth
    assert fri.commit_codeword(cw, log_coset).root == want.root
    for k in (0, dev_tree.depth - 1):
        assert np.array_equal(dev_tree.layer_np(k), want.layers[k])


def test_device_tree_keeps_wide_layers_and_opens_branches():
    cw = _codeword(1 << 11, seed=1)
    log_coset = 0
    dev_tree = tree.commit_codeword_device(from_reference(cw, "cpu"), log_coset, "cpu")
    n_leaves = cw.shape[0] >> log_coset
    assert len(dev_tree.dev_layers) == (n_leaves // tree._MIN_DEVICE_ROWS).bit_length() - 1
    assert dev_tree.top.layers[0].shape[0] == tree._MIN_DEVICE_ROWS
    leaves = dev_tree.layer_np(0)
    idx = [0, 5, n_leaves - 1]
    for i, br in zip(idx, dev_tree.branches_many(idx, dev_tree.depth)):
        assert tree.verify_branch(dev_tree.root, i, leaves[i].tobytes(), br)
    assert not tree.verify_branch(dev_tree.root, 1, leaves[0].tobytes(), dev_tree.branch(0))

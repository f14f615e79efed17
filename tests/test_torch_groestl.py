"""binius_tpu_torch Grøstl-256 (plain versions of K5 and K6) against the JAX
package: the fused-kernel numpy mirrors `groestl_pallas.leaf_hash_np` /
`pairs_np`, the host `groestl.compress_pairs`, and the spec tables the
kernels read. Bit-exact."""

import numpy as np
import pytest
import torch

from binius_tpu.hash import groestl as jg
from binius_tpu.hash import groestl_pallas as jgp
from binius_tpu.merkle.tree import hash_leaves
from binius_tpu.protocols.fri import leaf_blobs
from binius_tpu_torch.convert import from_reference, to_reference
from binius_tpu_torch.hash import groestl, groestl_cuda

torch.set_num_threads(1)  # the suite's test processes share the cores


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("log_coset,limbs", [(0, 4), (2, 4), (4, 4)])
def test_leaf_hash_matches_reference(log_coset, limbs):
    n = 32 << log_coset
    cw = _words((n, limbs), seed=log_coset)
    blob_len = (limbs * 4) << log_coset
    want = jgp.leaf_hash_np(cw, log_coset, blob_len)
    got = groestl_cuda.leaf_hash_kernel(from_reference(cw, "cpu"), log_coset, blob_len)
    assert np.array_equal(to_reference(got), want)


def test_long_leaves_match_reference():
    """The last FRI oracle's leaves: 2 of 1024 B128 elements (16 KiB, 257
    compressions each), against the JAX package's host digests."""
    cw = _words((2 << 10, 4), seed=10)
    got = groestl_cuda.leaf_hash_plain(from_reference(cw, "cpu"), 10, 16 << 10)
    want = hash_leaves(leaf_blobs(cw, 10))
    assert np.array_equal(to_reference(got).view(np.uint8).reshape(-1, 32), want)


def test_pairs_match_reference():
    d = _words((64, 8), seed=3)
    want = jgp.pairs_np(d)
    got = to_reference(groestl_cuda.pairs_kernel(from_reference(d, "cpu")))
    assert np.array_equal(got, want)
    host = jg.compress_pairs(np.ascontiguousarray(d).view(np.uint8).reshape(-1, 64))
    assert np.array_equal(got.view(np.uint8).reshape(-1, 32), host)
    # the tail: every level above the 32 pairs, stacked
    levels = [host]
    while levels[-1].shape[0] > 1:
        levels.append(jg.compress_pairs(levels[-1].reshape(-1, 64)))
    tail = to_reference(groestl_cuda.tail_kernel(from_reference(d, "cpu")))
    assert np.array_equal(tail.view(np.uint8).reshape(-1, 32), np.concatenate(levels))


@pytest.mark.parametrize("length", [0, 55, 64, 256])
def test_digests_match_reference(length):
    data = np.random.default_rng(length).integers(0, 256, size=(3, length), dtype=np.uint8)
    want = np.stack([np.frombuffer(jg.groestl256(r.tobytes()), dtype=np.uint8) for r in data])
    assert np.array_equal(groestl.hash_leaves_np(data), want)
    assert groestl.groestl256(data[0].tobytes()) == want[0].tobytes()


def test_kernel_tables_match_reference():
    t = groestl.kernel_tables_np()
    pc, qc = jg._col_consts()
    want = np.concatenate([np.array(jg._ttables(), dtype=np.uint64).reshape(-1),
                           np.array(pc, dtype=np.uint64).reshape(-1),
                           np.array(qc, dtype=np.uint64).reshape(-1)])
    assert np.array_equal(t, want)
    assert np.array_equal(groestl.aes_sbox(), jg.aes_sbox())
    assert np.array_equal(groestl.groestl256_pad(256), jg.groestl256_pad(256))

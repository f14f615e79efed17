"""The port's SHA-256 compression gadget and `examples/sha256.py`'s system
against the JAX package's, on the CPU.

The gadget's digests equal hashlib's for one-block messages (padded by
hand, one compression per row). At 2^0 compressions, the message words
from seed 0 (`sha256_inputs`, drawn as the example draws them): the
oracle set (3,000 oracles: 1,344 committed B1 columns, 1,272 shifted,
224 linear combinations, 80 transparents, 80 repeating), the constraint
set and the digest equal the JAX package's, and the witness equals the
JAX `populate`'s bit for bit; `validate_witness` accepts it and rejects
a flipped Ch bit; the port's proof has the JAX package's length and
sha256 (`chip_smoke.GOLDEN_CIRCUITS`, from `scripts/port_golden_proof.py
--circuit sha256`; the JAX prover is not run here), and the JAX verifier
accepts it. Exact comparisons throughout."""

import collections
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from scripts import port_golden_proof
from binius_tpu.constraint_system import prove as jcsp
from binius_tpu_torch import circuits
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system import system as cs_system
from binius_tpu_torch.m3.gadgets import sha256

torch.set_num_threads(1)  # the suite's test processes share the cores

SIZE, SEED = 0, 0


@pytest.fixture(scope="module")
def port():
    return circuits.instance("sha256", SIZE, SEED, "cpu")


@pytest.fixture(scope="module")
def reference():
    return port_golden_proof.sha256(SIZE, SEED)


def _one_block(msg: bytes) -> list:
    """The 16 big-endian words of a message of at most 55 bytes, padded."""
    block = msg + b"\x80" + bytes(55 - len(msg)) + (8 * len(msg)).to_bytes(8, "big")
    return [int.from_bytes(block[4 * i:4 * i + 4], "big") for i in range(16)]


def test_digest_equals_hashlib():
    msgs = [b"", b"abc", b"binius", bytes(range(55))]
    _, _, digest = sha256.sha256_system(2, [_one_block(m) for m in msgs], "cpu")
    for m, words in zip(msgs, digest):
        assert b"".join(int(w).to_bytes(4, "big") for w in words) == hashlib.sha256(m).digest()


def test_inputs_follow_the_example():
    import random

    random.seed(SEED)
    rows = [[random.getrandbits(32) for _ in range(16)] for _ in range(2)]
    assert sha256.sha256_inputs(1, SEED).tolist() == rows


def test_system_equals_reference(port, reference):
    ours, theirs = port[0], reference[0]
    assert [(o.id, o.n_vars, o.tower_level, o.variant, o.name, o.inner)
            for o in ours.oracles.oracles] == [
        (o.id, o.n_vars, o.tower_level, o.variant, o.name, o.inner)
        for o in theirs.oracles.oracles]
    kinds = collections.Counter(o.variant for o in ours.oracles.oracles)
    assert kinds == {"committed": 1344, "shifted": 1272, "linear_combination": 224,
                     "transparent": 80, "repeating": 80}
    assert [(c.n_vars, c.oracle_ids) for c in ours.constraint_sets] == [
        (c.n_vars, c.oracle_ids) for c in theirs.constraint_sets]
    assert ours.digest() == theirs.digest()
    assert port[2] == {}


def test_witness_equals_reference(port, reference):
    witness, jwitness = port[1], reference[1]
    assert set(witness) == set(jwitness)
    for oid, (jlvl, jdata) in jwitness.items():
        lvl, data = witness[oid]
        assert lvl == jlvl, oid
        assert np.array_equal(data.numpy().view(np.uint32),
                              np.asarray(jdata).view(np.uint32)), oid


def test_validate_witness(port):
    core, witness, _ = port
    cs_system.validate_witness(core, dict(witness))
    ch = next(o.id for o in core.oracles.oracles if o.name == "sha256.sha.r0.ch")
    lvl, data = witness[ch]
    data = data.clone()
    data[0] ^= 1
    with pytest.raises(ValueError):
        cs_system.validate_witness(core, {**witness, ch: (lvl, data)})


def test_proof_matches_golden(port, reference):
    core, witness, stmt = port
    proof = csp.prove(core, witness, device="cpu", **stmt)
    assert (SIZE, len(proof), hashlib.sha256(proof).hexdigest()) == \
        chip_smoke.GOLDEN_CIRCUITS["sha256"]
    jcsp.verify(reference[0], proof)

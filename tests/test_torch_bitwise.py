"""The port's u32 bitwise-ops circuit on the CPU against the JAX
package's.

`examples/bitwise_ops.py`'s table ("bitwise": committed xin and yin, B1
with 32 values per row, and their AND, XOR and OR through
`u32_bitwise_and` / `_xor` / `_or`) of 2^5 rows, the example's default,
x then y from numpy's `default_rng(0)`. Its XOR constraint, x + y + z, is
a composition of degree 1 inside a zerocheck claim of degree 2. Compared:
the oracle sets, the constraint set and the digest; the witness byte for
byte; the univariate-skip round count; `validate_witness` in both
packages (it accepts the witness and rejects one with a flipped output
bit); the port's proof against the JAX package's length and sha256
(`chip_smoke.GOLDEN_CIRCUITS`, from `scripts/port_golden_proof.py
--circuit bitwise_ops`; the JAX prover is not run here); and the port's
verifier on the proof and on flipped bytes. Exact comparisons
throughout."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from scripts import port_golden_proof
from binius_tpu_torch import circuits
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system import system as cs_system

SIZE, SEED = 5, 0


@pytest.fixture(scope="module")
def port():
    return circuits.instance("bitwise_ops", SIZE, SEED, "cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX package's system and witness, built as
    examples/bitwise_ops.py builds them (`scripts/port_golden_proof.build`)."""
    return port_golden_proof.build("bitwise_ops", SIZE, SEED)


@pytest.fixture(scope="module")
def proof(port):
    return csp.prove(port[0], port[1], log_inv_rate=1, device="cpu")


def test_system_equals_reference(port, reference):
    ours, theirs = port[0], reference[0]
    assert [(o.id, o.n_vars, o.tower_level, o.variant, o.name) for o in ours.oracles.oracles] \
        == [(o.id, o.n_vars, o.tower_level, o.variant, o.name) for o in theirs.oracles.oracles]
    assert len(ours.constraint_sets) == len(theirs.constraint_sets) == 1
    ocs, tcs = ours.constraint_sets[0], theirs.constraint_sets[0]
    assert (ocs.n_vars, ocs.oracle_ids) == (tcs.n_vars, tcs.oracle_ids)
    assert [e.serialize_tokens() for e in ocs.zero_constraints] == \
        [e.serialize_tokens() for e in tcs.zero_constraints]
    assert [e.degree() for e in ocs.zero_constraints] == [2, 1, 2]
    assert ours.digest() == theirs.digest()


def test_skip_rounds_equal_reference(port, reference):
    from binius_tpu.constraint_system import prove as jcsp

    assert csp._zerocheck_skip(port[0]) == jcsp._zerocheck_skip(reference[0]) == 7


def test_witness_equals_reference(port, reference):
    for oid, (lvl, d) in port[1].items():
        jl, jd = reference[1][oid]
        assert lvl == jl
        assert np.array_equal(d.numpy().view(np.uint32), np.asarray(jd).view(np.uint32))


def _flipped(witness, oid):
    """The witness with one bit of oracle `oid`'s row 3 flipped."""
    lvl, d = witness[oid]
    d = d.clone() if isinstance(d, torch.Tensor) else np.array(d)
    d[3] ^= 1 << 4
    return {**witness, oid: (lvl, d)}


@pytest.mark.parametrize("k", [0, 1, 2])
def test_validate_witness(port, k):
    """Each output column (AND, XOR, OR) flipped violates its constraint."""
    core, witness, _ = port
    cs_system.validate_witness(core, dict(witness))
    out_id = core.constraint_sets[0].oracle_ids[2 + k]
    with pytest.raises(ValueError, match=f"zero constraint {k}"):
        cs_system.validate_witness(core, _flipped(witness, out_id))


def test_reference_validate_witness(reference):
    import jax.numpy as jnp
    from binius_tpu.constraint_system.system import validate_witness as jvalidate

    core, witness = reference
    jvalidate(core, witness)
    out_id = core.constraint_sets[0].oracle_ids[3]
    bad = {oid: (lvl, jnp.asarray(d)) for oid, (lvl, d) in _flipped(witness, out_id).items()}
    with pytest.raises(ValueError, match="zero constraint 1"):
        jvalidate(core, bad)


def test_proof_matches_jax_digest(proof):
    size, n_bytes, sha = chip_smoke.GOLDEN_CIRCUITS["bitwise_ops"]
    assert size == SIZE
    assert (len(proof), hashlib.sha256(proof).hexdigest()) == (n_bytes, sha)


@pytest.mark.parametrize("offset", [0, 1000, 5000])
def test_verifier_accepts_and_rejects_a_flipped_byte(port, proof, offset):
    core = port[0]
    csp.verify(core, proof, log_inv_rate=1, device="cpu")
    bad = bytearray(proof)
    bad[offset] ^= 1
    with pytest.raises((ValueError, EOFError)):
        csp.verify(core, bytes(bad), log_inv_rate=1, device="cpu")

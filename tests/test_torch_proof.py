"""The port's whole u32_add proof on the CPU: `constraint_system.prove` on
the golden 8-row instance (built as `test_golden_transcript.py::
test_proof_self_golden` builds it) gives exactly the JAX package's pinned
bytes (`tests/fixtures/proof_self_golden.json`); each package's verifier
accepts the other's proof (at 2^11 rows too) and the port's rejects flipped
bytes; the system
digest and the witness equal the JAX package's. The JAX package's prover
is not run (its compile alone takes minutes on a CPU): the fixture holds
its bytes. Exact comparisons throughout."""

import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system.system import Flush
from binius_tpu_torch.convert import witness_from_reference
from binius_tpu_torch.m3.gadgets import arith

torch.set_num_threads(1)  # the suite's test processes share the cores

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "proof_self_golden.json")


def _golden_rows():
    rng = random.Random(42)
    xs = [rng.getrandbits(32) for _ in range(8)]
    ys = [rng.getrandbits(32) for _ in range(8)]
    return xs, ys


@pytest.fixture(scope="module")
def golden():
    xs, ys = _golden_rows()
    core, witness = arith.u32_add_system(3, xs, ys, "cpu")
    return core, witness, csp.prove(core, witness, log_inv_rate=1, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX package's golden system and witness (its M3 front end)."""
    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.builder.witness import WitnessIndex
    from binius_tpu.m3.gadgets import arith as jarith

    xs, ys = _golden_rows()
    m3 = M3ConstraintSystem()
    t = m3.add_table("u32add")
    xin = t.add_committed("xin", 0, jarith.LOG_U32)
    yin = t.add_committed("yin", 0, jarith.LOG_U32)
    adder = jarith.U32Add.build(t, "add", xin, yin)
    core, omap = m3.compile([3])
    wi = WitnessIndex(m3, [3])
    tw = wi.table(0)
    tw.set_packed_ints(xin, xs)
    tw.set_packed_ints(yin, ys)
    adder.populate(tw, xs, ys)
    witness = {oid: (lvl, np.asarray(d)) for oid, (lvl, d) in
               wi.to_core_witness(core, omap).items()}
    return core, witness


def test_golden_proof_matches_fixture(golden):
    with open(FIXTURE) as f:
        want = json.load(f)
    proof = golden[2]
    assert len(proof) == want["n_bytes"] == 7328
    assert hashlib.sha256(proof).hexdigest() == want["sha256"]


def test_port_verifier_accepts(golden):
    core, _, proof = golden
    csp.verify(core, proof, log_inv_rate=1, device="cpu")


@pytest.mark.parametrize("offset", [0, 40, 3000, 7327])
def test_port_verifier_rejects_a_flipped_byte(golden, offset):
    core, _, proof = golden
    bad = bytearray(proof)
    bad[offset] ^= 1
    with pytest.raises((ValueError, EOFError)):
        csp.verify(core, bytes(bad), log_inv_rate=1, device="cpu")


def test_system_digest_matches_reference(golden, reference):
    assert golden[0].digest() == reference[0].digest()
    ours, ref = golden[0], reference[0]
    assert [(o.n_vars, o.tower_level, o.variant, o.inner, o.shift_offset, o.shift_block_bits,
             o.shift_variant, o.name) for o in ours.oracles.oracles] == [
        (o.n_vars, o.tower_level, o.variant, o.inner, o.shift_offset, o.shift_block_bits,
         o.shift_variant, o.name) for o in ref.oracles.oracles]
    assert [(s.n_vars, s.oracle_ids, tuple(e.serialize_tokens() for e in s.zero_constraints))
            for s in ours.constraint_sets] == [
        (s.n_vars, s.oracle_ids, tuple(e.serialize_tokens() for e in s.zero_constraints))
        for s in ref.constraint_sets]


def test_witness_from_reference_has_the_same_bits(golden, reference):
    ours = golden[1]
    theirs = witness_from_reference(reference[1], "cpu")
    assert sorted(ours) == sorted(theirs)
    for oid in ours:
        assert ours[oid][0] == theirs[oid][0]
        assert bool((ours[oid][1] == theirs[oid][1]).all())


def test_proof_from_reference_witness_matches(golden, reference):
    core = golden[0]
    witness = witness_from_reference(reference[1], "cpu")
    assert csp.prove(core, witness, log_inv_rate=1, device="cpu") == golden[2]


def test_reference_verifier_accepts_port_proof(golden, reference):
    from binius_tpu.constraint_system import prove as jcsp
    jcsp.verify(reference[0], golden[2], log_inv_rate=1)


def test_reference_verifier_accepts_a_larger_port_proof():
    """2^11 rows (a FRI with a fold oracle, unlike the golden 8 rows): the
    port's proof verifies with the JAX package's system and verifier."""
    from binius_tpu.constraint_system import prove as jcsp
    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.gadgets import arith as jarith

    x, y = arith.u32_add_rows(11, 1)
    core, witness = arith.u32_add_system(11, x, y, "cpu")
    proof = csp.prove(core, witness, device="cpu")
    m3 = M3ConstraintSystem()
    t = m3.add_table("u32add")
    jarith.U32Add.build(t, "add", t.add_committed("xin", 0, jarith.LOG_U32),
                        t.add_committed("yin", 0, jarith.LOG_U32))
    jcore, _ = m3.compile([11])
    assert csp.make_fri_params(csp.CommitLayout.from_system(core).commit_meta, 1).fold_arities
    jcsp.verify(jcore, proof, log_inv_rate=1)
    csp.verify(core, proof, device="cpu")


def test_phase_times_are_recorded(golden):
    xs, ys = _golden_rows()
    core, witness = arith.u32_add_system(3, xs, ys, "cpu")
    csp.prove(core, witness, device="cpu")
    phases = {k for k in csp.last_phase_times if "/" not in k}   # not the spans inside them
    assert phases == {"commit", "exp", "gpa", "zerocheck", "evalcheck", "ring_switch", "piop",
                      "total"}


def test_unported_phases_raise(golden):
    """The grand-product phase, once refused, is ported: a push that no
    pull balances is rejected as the JAX package rejects it."""
    core, witness, _ = golden
    core = csp.ConstraintSystem(core.oracles, core.constraint_sets, [Flush(0, "push", (0,))], 1)
    with pytest.raises(ValueError, match="channel 0 is not balanced"):
        csp.prove(core, witness, device="cpu")

"""The port's keccak_lookups system (Keccak-f with chi through the bit-AND
lookup channel) on the CPU against the JAX package's.

`examples/keccak_lookups.py`'s system (`KeccakLookedupCS`: the keccak
table and the 4-row bit-AND table, no constraint set, 618 flushes at 2^0
permutations) with lanes from seed 0. Compared: the oracle sets, the
flush list (channels, directions, columns, multiplicities, selectors
with each StepDown last), the non-zero claims, the digest; the witness
byte for byte; `validate_witness` in both packages (it accepts the
witness and rejects one with a flipped round-output bit); the port's
proof against the JAX package's length and sha256
(`chip_smoke.GOLDEN_CIRCUITS`, from `scripts/port_golden_proof.py
--circuit keccak_lookups`; the JAX prover is not run here), which the JAX
verifier accepts; its grand-product layers and flush composites run as
stacked provers, one per layer or batch. At 3 permutations, not a power of two: the digest and
the StepDown selectors equal the JAX package's `compile_sizes([3, 4])`,
and the port's `m3_prove` / `m3_verify` round-trip with the table sizes
read from the proof. Exact comparisons throughout."""

import hashlib

import numpy as np
import pytest

import chip_smoke
from scripts import port_golden_proof
from binius_tpu.constraint_system import prove as jcsp
from binius_tpu.constraint_system import system as jsystem
from binius_tpu_torch import circuits
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system import system as cs_system
from binius_tpu_torch.fields import tower
from binius_tpu_torch.m3.builder import statement
from binius_tpu_torch.m3.builder.table import M3ConstraintSystem
from binius_tpu_torch.m3.builder.witness import WitnessIndex
from binius_tpu_torch.m3.gadgets import keccak
from binius_tpu_torch.protocols.sumcheck import prove as sc_prove

SIZE, SEED = 0, 0


@pytest.fixture(scope="module")
def port():
    return circuits.instance("keccak_lookups", SIZE, SEED, "cpu")


@pytest.fixture(scope="module")
def reference():
    return port_golden_proof.statement("keccak_lookups", SIZE, SEED)


def _flushes(core):
    return [(f.channel_id, f.direction, f.oracle_ids, f.multiplicity, f.selector_ids)
            for f in core.flushes]


def _oracles(core):
    return [(o.id, o.n_vars, o.tower_level, o.variant, o.name, o.inner)
            for o in core.oracles.oracles]


def test_system_equals_reference(port, reference):
    ours, theirs = port[0], reference[0]
    assert not ours.constraint_sets and not theirs.constraint_sets
    assert _oracles(ours) == _oracles(theirs)
    assert len(ours.oracles) == 2708 and len(ours.flushes) == 618
    assert _flushes(ours) == _flushes(theirs)
    assert [nz.oracle_id for nz in ours.non_zero_claims] == \
        [nz.oracle_id for nz in theirs.non_zero_claims]
    assert ours.digest() == theirs.digest()
    assert port[2] == reference[2] == {"table_sizes": [1, 4]}


def test_witness_equals_reference(port, reference):
    witness, jwitness = port[1], reference[1]
    assert set(witness) == set(jwitness)
    for oid, (jlvl, jdata) in jwitness.items():
        lvl, data = witness[oid]
        assert lvl == jlvl, oid
        assert np.array_equal(data.numpy().view(np.uint32),
                              np.asarray(jdata).view(np.uint32)), oid


def test_validate_witness(port, reference):
    core, witness, _ = port
    cs_system.validate_witness(core, dict(witness))
    jsystem.validate_witness(reference[0], dict(reference[1]))
    # a flipped round-output bit leaves the bit-AND table: no balance
    oid = max(oid for oid, (lvl, _) in witness.items() if lvl == 0)
    lvl, data = witness[oid]
    data = data.clone()
    data[0] ^= 1
    with pytest.raises(ValueError, match="not balanced"):
        cs_system.validate_witness(core, {**witness, oid: (lvl, data)})


def test_proof_matches_golden(port, reference, monkeypatch):
    """The golden bytes; the grand-product layers and the evalcheck's flush
    composites run as stacked provers: one per GPA layer (618 instances
    at layers 0 and 1, the 600 pulls above), one for the 600 pull
    composites at 6 variables and one for the 16 multiplicity-bit
    composites at 2."""
    core, witness, stmt = port
    made = []
    init = sc_prove.EqStackedSumcheckProver.__init__

    def recording(self, claims, *a, **k):
        made.append((claims[0].n_vars, len(claims)))
        init(self, claims, *a, **k)

    monkeypatch.setattr(sc_prove.EqStackedSumcheckProver, "__init__", recording)
    proof = csp.prove(core, witness, device="cpu", **stmt)
    assert made == [(0, 618), (1, 618), (2, 600), (3, 600), (4, 600), (5, 600),
                    (6, 600), (2, 16)]
    assert (SIZE, len(proof), hashlib.sha256(proof).hexdigest()) == \
        chip_smoke.GOLDEN_CIRCUITS["keccak_lookups"]
    assert csp.peek_table_sizes(proof) == [1, 4]
    jcsp.verify(reference[0], proof, **reference[2])
    with pytest.raises(ValueError, match="table sizes"):
        csp.verify(core, proof, table_sizes=[2, 4], device="cpu")


def test_three_permutations_round_trip():
    """3 permutations in a capacity of 4: the keccak table's flushes carry
    StepDown(8, 3 << 6); `m3_prove` / `m3_verify` read the sizes back."""
    from binius_tpu.m3.builder.table import M3ConstraintSystem as JM3
    from binius_tpu.m3.gadgets.keccak import KeccakLookedupCS as JCS

    m3 = M3ConstraintSystem()
    cs = keccak.KeccakLookedupCS.build(m3, 2)
    core, _ = m3.compile_sizes([3, 4])
    jm3 = JM3()
    JCS.build(jm3, 2)
    jcore, _ = jm3.compile_sizes([3, 4])
    assert core.digest() == jcore.digest()
    assert _flushes(core) == _flushes(jcore)
    step_downs = [(o.transparent.n_vars, o.transparent.index, o.name) for o in core.oracles.oracles
                  if type(o.transparent).__name__ == "StepDown"]
    assert step_downs == [(o.transparent.n_vars, o.transparent.index, o.name)
                          for o in jcore.oracles.oracles
                          if type(o.transparent).__name__ == "StepDown"]
    assert step_downs == [(8, 3 << 6, "keccak_lookedup.stepdown6")]

    rows = keccak.keccak_inputs(2, SEED)[:3]
    wi = WitnessIndex.with_sizes(m3, cs.table_sizes(3))
    outs = cs.populate(wi, rows)
    assert outs == [keccak.keccak_f(r) for r in rows]
    proof = statement.m3_prove(m3, wi, device="cpu")
    assert csp.peek_table_sizes(proof) == [3, 4]
    statement.m3_verify(m3, proof, device="cpu")
    step_down = next(o for o in core.oracles.oracles if o.name.endswith("stepdown6"))
    assert tower.to_ints(*step_down.transparent.mle("cpu")) == [1] * 192 + [0] * 64

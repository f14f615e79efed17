"""The port's u32 multiplication through the GKR exponentiation phase on
the CPU against the JAX package's.

`examples/u32_mul_gkr.py`'s table ("mul", one `MulUU32`) of 2^7 products,
the smallest size whose one-bit-per-row columns the witness holds as P1
words, as it does at the grid's 2^20; x then y from `random.seed(0)`.
Compared: the oracle sets, the constraint set, the exponents (in the
system and in the canonical symbolic form) and the digest; the witness,
the four exponent result columns that the prover fills included, byte
for byte; `validate_witness` in both packages, which accepts the witness
and rejects one with a flipped `out_low` bit (the exponent columns are
recomputed from the bits, so the exponentiation-equality constraint is
the one violated); the port's proof against the JAX package's length and
sha256 (`chip_smoke.GOLDEN_CIRCUITS`, from `scripts/port_golden_proof.py
--circuit u32_mul_gkr`; the JAX prover is not run here); and the port's
verifier on the proof and on flipped bytes. Exact comparisons
throughout."""

import hashlib

import numpy as np
import pytest

import chip_smoke
from scripts import port_golden_proof
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system import system as cs_system
from binius_tpu_torch.m3.gadgets import mul

SIZE, SEED = 7, 0


@pytest.fixture(scope="module")
def port():
    return mul.mul_system(SIZE, *mul.mul_inputs(SIZE, SEED), "cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX package's system and witness, built as
    examples/u32_mul_gkr.py builds them (`scripts/port_golden_proof.build`)."""
    return port_golden_proof.build("u32_mul_gkr", SIZE, SEED)


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
    assert [e.tokens() for e in ours.exponents] == [e.tokens() for e in theirs.exponents]
    assert len(ours.exponents) == 4
    assert [(e.bits_ids, e.base, e.exp_result_id) for e in ours.symbolic.exponents] == \
        [(e.bits_ids, e.base, e.exp_result_id) for e in theirs.symbolic.exponents]
    assert ours.digest() == theirs.digest()


def test_witness_equals_reference(port, reference):
    ours, theirs = port[1], reference[1]
    for e in port[0].exponents:
        assert ours[e.exp_result_id][0] == 6
    for oid, (lvl, d) in ours.items():
        jl, jd = theirs[oid]
        assert lvl == jl
        assert np.array_equal(d.numpy().view(np.uint32), np.asarray(jd).view(np.uint32))


def _flip_out_low_bit(tw, gadget) -> None:
    """Bit 7 of out_low in row 1 (`tests/test_mul_gadget.py`)."""
    vals = tw.get_column(gadget.out_low_bits[7])
    vals[1] ^= 1
    tw.set_column(gadget.out_low_bits[7], vals)


def test_validate_witness(port):
    from binius_tpu_torch.m3.builder.witness import WitnessIndex

    core, witness = port
    cs_system.validate_witness(core, dict(witness))
    m3, gadget, core2, omap = mul.mul_table(SIZE)
    wi = WitnessIndex(m3, [SIZE])
    gadget.populate(wi.table(0), *mul.mul_inputs(SIZE, SEED))
    _flip_out_low_bit(wi.table(0), gadget)
    with pytest.raises(ValueError, match="zero constraint 1"):
        cs_system.validate_witness(core2, wi.to_core_witness(core2, omap, "cpu"))


def test_exponent_result_mismatch_rejected(port):
    core, witness = port[0], dict(port[1])
    rid = core.exponents[0].exp_result_id
    lvl, d = witness[rid]
    d = d.clone()
    d[3, 0] ^= 1
    witness[rid] = (lvl, d)
    with pytest.raises(ValueError, match="does not match base"):
        cs_system.validate_witness(core, witness)


def test_reference_validate_witness():
    from binius_tpu.constraint_system.system import validate_witness as jvalidate
    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.builder.witness import WitnessIndex
    from binius_tpu.m3.gadgets.mul import MulUU32

    xs, ys = mul.mul_inputs(SIZE, SEED)
    for flip in (False, True):
        m3 = M3ConstraintSystem()
        gadget = MulUU32.build(m3.add_table("mul"), "mul")
        core, omap = m3.compile([SIZE])
        wi = WitnessIndex(m3, [SIZE])
        gadget.populate(wi.table(0), [int(x) for x in xs], [int(y) for y in ys])
        if flip:
            _flip_out_low_bit(wi.table(0), gadget)
            with pytest.raises(ValueError, match="zero constraint 1"):
                jvalidate(core, wi.to_core_witness(core, omap))
        else:
            jvalidate(core, wi.to_core_witness(core, omap))


def test_proof_matches_jax_digest(proof):
    size, n_bytes, sha = chip_smoke.GOLDEN_CIRCUITS["u32_mul_gkr"]
    assert size == SIZE
    assert (len(proof), hashlib.sha256(proof).hexdigest()) == (n_bytes, sha)


@pytest.mark.parametrize("offset", [40, 20000, 100000])
def test_verifier_accepts_and_rejects_a_flipped_byte(port, proof, offset):
    core = port[0]
    csp.verify(core, proof, log_inv_rate=1, device="cpu")
    bad = bytearray(proof)
    bad[offset] ^= 1
    with pytest.raises((ValueError, EOFError)):
        csp.verify(core, bytes(bad), log_inv_rate=1, device="cpu")

"""The port's B32 multiplication circuit on the CPU against the JAX
package's.

`examples/b32_mul.py`'s hand-built system (three committed B32 oracles and
A*B + C = 0) of 2^10 products whose inputs numpy's `default_rng(0)` draws:
the oracle sets and the digest of a hand-built system (a Grøstl-256 of the
`repr` of its structural tokens) against the JAX package's, the witnesses
byte for byte, `validate_witness` in both packages (it accepts the witness
and rejects one flipped bit; the port's also checks an exponent added to
the system), the port's proof against the JAX package's
length and sha256 (`chip_smoke.GOLDEN_CIRCUITS`, from
`scripts/port_golden_proof.py --circuit b32_mul`; the JAX prover is not run
here), and the port's verifier on the proof and on a flipped byte. Exact
comparisons throughout."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from scripts import port_golden_proof
from binius_tpu_torch.constraint_system import oracle as om
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system import system as cs_system
from binius_tpu_torch.math.arith import ArithExpr
from binius_tpu_torch.m3.gadgets import b32_mul

SIZE, SEED = 10, 0


@pytest.fixture(scope="module")
def port():
    core = b32_mul.b32_mul_system(SIZE)
    return core, b32_mul.b32_mul_witness(core, *b32_mul.b32_mul_inputs(SIZE, SEED), "cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX package's system and witness, built as examples/b32_mul.py
    builds them (`scripts/port_golden_proof.build`)."""
    return port_golden_proof.build("b32_mul", SIZE, SEED)


@pytest.fixture(scope="module")
def proof(port):
    return csp.prove(port[0], port[1], log_inv_rate=1, device="cpu")


def test_system_equals_reference(port, reference):
    ours, theirs = port[0], reference[0]
    assert [(o.id, o.n_vars, o.tower_level, o.variant, o.name) for o in ours.oracles.oracles] \
        == [(o.id, o.n_vars, o.tower_level, o.variant, o.name) for o in theirs.oracles.oracles]
    assert ours.constraint_sets[0].oracle_ids == theirs.constraint_sets[0].oracle_ids
    assert ours.constraint_sets[0].zero_constraints[0].serialize_tokens() == \
        theirs.constraint_sets[0].zero_constraints[0].serialize_tokens()
    assert ours.symbolic is None and theirs.symbolic is None
    assert ours.digest() == theirs.digest()


def test_structural_digest_with_flushes_and_claims_equals_reference():
    """The hand-built digest's tokens of every kind: virtual oracles,
    flushes, channels and non-zero claims."""
    from binius_tpu.constraint_system import oracle as jom
    from binius_tpu.constraint_system import system as jsys
    from binius_tpu.math.arith import ArithExpr as JExpr
    from binius_tpu.protocols import shift_ind as jshift

    systems = []
    for o_mod, s_mod, expr_cls, circ in ((om, cs_system, ArithExpr, "circular_left"),
                                         (jom, jsys, JExpr, jshift.CIRCULAR_LEFT)):
        oracles = o_mod.OracleSet()
        a = oracles.add_committed(6, 0, "a")
        b = oracles.add_committed(6, 3, "b")
        sh = oracles.add_shifted(a, 3, 4, circ, "sh")
        lc = oracles.add_linear_combination(6, [(a, 1), (b, 0x53)], 7, "lc")
        rep = oracles.add_repeating(b, 2, "rep")
        X, Y = expr_cls.var(0), expr_cls.var(1)
        systems.append(s_mod.ConstraintSystem(
            oracles, [s_mod.ConstraintSet(6, (a, sh, lc), (X * Y + expr_cls.const(0x1F, 5),))],
            flushes=[s_mod.Flush(0, s_mod.PUSH, (b, lc), 2, (a,))], n_channels=1,
            non_zero_claims=[s_mod.NonZeroClaim(rep)]))
    assert systems[0].digest() == systems[1].digest()


def test_witness_equals_reference(port, reference):
    for oid, (lvl, d) in port[1].items():
        jl, jd = reference[1][oid]
        assert lvl == jl
        assert np.array_equal(d.numpy().view(np.uint32), np.asarray(jd).view(np.uint32))


def _flipped(witness):
    c_id = max(witness)
    lvl, d = witness[c_id]
    d = d.clone() if isinstance(d, torch.Tensor) else np.array(d)
    d[7] ^= 1 << 30
    return {**witness, c_id: (lvl, d)}


def test_validate_witness(port):
    core, witness = port
    cs_system.validate_witness(core, witness)
    with pytest.raises(ValueError, match="zero constraint 0"):
        cs_system.validate_witness(core, _flipped(witness))


def test_reference_validate_witness(reference):
    import jax.numpy as jnp
    from binius_tpu.constraint_system.system import validate_witness as jvalidate

    core, witness = reference
    jvalidate(core, witness)
    bad = {oid: (lvl, jnp.asarray(d)) for oid, (lvl, d) in _flipped(witness).items()}
    with pytest.raises(ValueError, match="zero constraint 0"):
        jvalidate(core, bad)


def test_validate_witness_refuses_exponents(port):
    """A system with an exponent (g^b over one B1 bit column b, g the B32
    generator): its result column is recomputed from the bits, so the
    right column is accepted and a wrong one refused."""
    from binius_tpu_torch.constraint_system.exp import Exp
    from binius_tpu_torch.fields import scalar, tower

    core = b32_mul.b32_mul_system(2)
    bit = core.oracles.add_committed(2, 0, "b")
    res = core.oracles.add_committed(2, 5, "g^b")
    g = scalar.GENERATORS[5]
    core.exponents = [Exp((bit,), res, 5, base_const=g)]
    bits = [1, 0, 1, 1]
    witness = b32_mul.b32_mul_witness(core, *b32_mul.b32_mul_inputs(2, SEED), "cpu")
    witness[bit] = (0, tower.from_ints(0, bits, "cpu"))
    witness[res] = (5, tower.from_ints(5, [g if v else 1 for v in bits], "cpu"))
    cs_system.validate_witness(core, dict(witness))
    witness[res] = (5, tower.from_ints(5, [g, 1, g, 1], "cpu"))
    with pytest.raises(ValueError, match="does not match base"):
        cs_system.validate_witness(core, witness)


def test_proof_matches_jax_digest(proof):
    size, n_bytes, sha = chip_smoke.GOLDEN_CIRCUITS["b32_mul"]
    assert size == SIZE
    assert (len(proof), hashlib.sha256(proof).hexdigest()) == (n_bytes, sha)


@pytest.mark.parametrize("offset", [0, 1000, 20000])
def test_verifier_accepts_and_rejects_a_flipped_byte(port, proof, offset):
    core = port[0]
    csp.verify(core, proof, log_inv_rate=1, device="cpu")
    bad = bytearray(proof)
    bad[offset] ^= 1
    with pytest.raises((ValueError, EOFError)):
        csp.verify(core, bytes(bad), log_inv_rate=1, device="cpu")

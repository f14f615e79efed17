"""The port's Grøstl permutation circuit on the CPU against the JAX
package's.

Each package's own builder (`examples/groestl.py`'s table of P
permutations, and the Q variant) takes the states of one seed
(`random.Random`: the port's `groestl_inputs`, the JAX side's
`scripts/port_golden_proof.build`): the trace against the port's own Grøstl permutation
(`hash/groestl.py`), the oracle sets field by field, the system digests,
the witnesses byte for byte, and `validate_witness` in both packages (it
accepts the witness and rejects one flipped bit). The port's proof of 2^3
P permutations must have the length and sha256 of the JAX package's
(`chip_smoke.GOLDEN_CIRCUITS`, from `scripts/port_golden_proof.py
--circuit groestl`; the JAX prover is not run here), and its verifier
accepts the proof and rejects a flipped byte. Exact comparisons
throughout."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from scripts import port_golden_proof
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system.system import validate_witness
from binius_tpu_torch.fields import isomorphism
from binius_tpu_torch.hash import groestl as hgroestl
from binius_tpu_torch.m3.builder.table import M3ConstraintSystem
from binius_tpu_torch.m3.builder.witness import WitnessIndex
from binius_tpu_torch.m3.gadgets import groestl

SIZE, SEED = 3, 0
ORACLE_FIELDS = ("id", "n_vars", "tower_level", "variant", "inner", "shift_offset",
                 "shift_block_bits", "shift_variant", "lc_offset", "lc_coeffs", "log_degree",
                 "name")


def _port(variant: str, log_n: int):
    if variant == "P":
        return groestl.groestl_system(log_n, groestl.groestl_inputs(log_n, SEED), "cpu")
    m3 = M3ConstraintSystem()
    t = m3.add_table("groestl_q")
    g = groestl.Permutation.build(t, "perm", "Q")
    core, omap = m3.compile([log_n])
    wi = WitnessIndex(m3, [log_n])
    outs = g.populate(wi.table(0), groestl.groestl_inputs(log_n, SEED))
    return core, wi.to_core_witness(core, omap, "cpu"), outs


def _reference(variant: str, log_n: int):
    """The JAX package's system and witness (numpy), built as
    examples/groestl.py builds them (`scripts/port_golden_proof.build`)."""
    core, witness = port_golden_proof.build("groestl", log_n, SEED, variant)
    return core, {oid: (lvl, np.asarray(d)) for oid, (lvl, d) in witness.items()}


@pytest.fixture(scope="module")
def port():
    return _port("P", SIZE)


@pytest.fixture(scope="module")
def reference():
    return _reference("P", SIZE)


@pytest.fixture(scope="module")
def proof(port):
    return csp.prove(port[0], port[1], log_inv_rate=1, device="cpu")


def test_isomorphism_matrices_equal_reference():
    from binius_tpu.fields import isomorphism as jiso
    assert isomorphism.aes_to_canonical_b8_matrix() == jiso.aes_to_canonical_b8_matrix()
    assert isomorphism.canonical_to_aes_b8_matrix() == jiso.canonical_to_aes_b8_matrix()


def test_derived_constants_equal_reference():
    from binius_tpu.m3.gadgets import groestl as jg
    assert groestl.sbox_tower_matrix_cols() == jg.sbox_tower_matrix_cols() == (
        0x62, 0xD2, 0x79, 0x41, 0xF4, 0xD5, 0x81, 0x4E)
    assert groestl.sbox_tower_offset() == jg.sbox_tower_offset() == 0x14
    assert groestl.mix_tower_scalars() == jg.mix_tower_scalars()
    for r in range(groestl.N_ROUNDS):
        assert groestl.round_consts_tower(r) == jg.round_consts_tower(r)


@pytest.mark.parametrize("variant", ["P", "Q"])
def test_trace_is_the_permutation(variant):
    states = groestl.groestl_inputs(2, SEED)
    outs = _port(variant, 2)[2]
    want = hgroestl._permute(torch.from_numpy(states), is_q=variant == "Q").numpy()
    assert np.array_equal(outs, want)


@pytest.mark.parametrize("variant", ["P", "Q"])
def test_system_and_witness_equal_reference(variant):
    core, witness, _ = _port(variant, 1)
    jcore, jwitness = _reference(variant, 1)
    assert len(core.oracles) == len(jcore.oracles) == 978
    for o, j in zip(core.oracles.oracles, jcore.oracles.oracles):
        for f in ORACLE_FIELDS:
            assert getattr(o, f) == getattr(j, f), (o.id, f)
    assert core.digest() == jcore.digest()
    assert sorted(witness) == sorted(jwitness)
    for oid, (lvl, d) in witness.items():
        assert lvl == jwitness[oid][0], oid
        assert np.array_equal(d.numpy().view(np.uint32), jwitness[oid][1].view(np.uint32)), oid


def test_digest_and_witness_equal_reference(port, reference):
    assert port[0].digest() == reference[0].digest()
    for oid, (lvl, d) in port[1].items():
        assert lvl == reference[1][oid][0], oid
        assert np.array_equal(d.numpy().view(np.uint32), reference[1][oid][1].view(np.uint32))


def _flip_input_bit(oracles, witness):
    """The committed columns with bit 3 of the first value of `perm.in1` (a
    B8 state column the S-box constraints read) flipped."""
    out = {oid: witness[oid] for oid in oracles.committed_ids()}
    oid = next(o.id for o in oracles.oracles if o.name == "groestl_p.perm.in1")
    lvl, d = out[oid]
    d = d.clone() if isinstance(d, torch.Tensor) else np.array(d)
    d[0] ^= 1 << 3
    out[oid] = (lvl, d)
    return out


def test_validate_witness(port):
    core, witness, _ = port
    validate_witness(core, dict(witness))
    with pytest.raises(ValueError, match="zero constraint"):
        validate_witness(core, _flip_input_bit(core.oracles, witness))


def test_reference_validate_witness(reference):
    import jax.numpy as jnp
    from binius_tpu.constraint_system import witness as jwitness
    from binius_tpu.constraint_system.system import validate_witness as jvalidate

    core = reference[0]
    jvalidate(core, {oid: (lvl, jnp.asarray(d)) for oid, (lvl, d) in reference[1].items()})
    bad = {oid: (lvl, jnp.asarray(d)) for oid, (lvl, d)
           in _flip_input_bit(core.oracles, reference[1]).items()}
    for oid in range(len(core.oracles)):
        jwitness.materialize(core.oracles, bad, oid)
    with pytest.raises(ValueError, match="zero constraint"):
        jvalidate(core, bad)


def test_proof_matches_jax_digest(proof):
    size, n_bytes, sha = chip_smoke.GOLDEN_CIRCUITS["groestl"]
    assert size == SIZE
    assert (len(proof), hashlib.sha256(proof).hexdigest()) == (n_bytes, sha)


def test_verifier_accepts_and_rejects_a_flipped_byte(port, proof):
    core = port[0]
    csp.verify(core, proof, log_inv_rate=1, device="cpu")
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 1
    with pytest.raises((ValueError, EOFError)):
        csp.verify(core, bytes(bad), log_inv_rate=1, device="cpu")

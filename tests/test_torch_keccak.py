"""The port's Keccak-f[1600] circuit on the CPU against the JAX package's.

Each package's own builder (`examples/keccak.py`'s table of 2^1
permutations) takes the inputs of one seed (`random.Random(0)`: the port's
`keccak_inputs`, the JAX side's `scripts/port_golden_proof.build`):
the oracle sets are compared field by field, then the system digests, the
witnesses byte for byte and `validate_witness` in both packages (it
accepts the witness and rejects one flipped bit). The port's proof must
have the length and sha256 of the JAX package's (`chip_smoke.
GOLDEN_CIRCUITS`, from `scripts/port_golden_proof.py --circuit keccak`;
the JAX prover itself is not run here), and its verifier accepts the proof
and rejects a flipped byte. Exact comparisons throughout."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from scripts import port_golden_proof
from binius_tpu_torch.constraint_system import oracle as om
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system.system import validate_witness
from binius_tpu_torch.fields import tower
from binius_tpu_torch.m3.gadgets import keccak

torch.set_num_threads(1)  # the suite's test processes share the cores

SIZE, SEED = 1, 0
ORACLE_FIELDS = ("id", "n_vars", "tower_level", "variant", "inner", "shift_offset",
                 "shift_block_bits", "shift_variant", "lc_offset", "lc_coeffs", "log_degree",
                 "name")


@pytest.fixture(scope="module")
def port():
    return keccak.keccak_system(SIZE, keccak.keccak_inputs(SIZE, SEED), "cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX package's system and witness (numpy), built as
    examples/keccak.py builds them (`scripts/port_golden_proof.build`)."""
    core, witness = port_golden_proof.build("keccak", SIZE, SEED)
    return core, {oid: (lvl, np.asarray(d)) for oid, (lvl, d) in witness.items()}


@pytest.fixture(scope="module")
def proof(port):
    return csp.prove(port[0], port[1], log_inv_rate=1, device="cpu")


def _sha3_256(msg: bytes, permute) -> bytes:
    rate = 136
    p = bytearray(msg)
    p.append(0x06)
    while len(p) % rate:
        p.append(0)
    p[-1] |= 0x80
    lanes = [0] * 25
    for off in range(0, len(p), rate):
        for i in range(rate // 8):
            lanes[i] ^= int.from_bytes(p[off + 8 * i:off + 8 * i + 8], "little")
        lanes = permute(lanes)
    return b"".join(v.to_bytes(8, "little") for v in lanes[:4])


@pytest.mark.parametrize("msg", [b"", b"abc", bytes(range(200))])
def test_keccak_f_matches_sha3(msg):
    assert _sha3_256(msg, keccak.keccak_f) == hashlib.sha3_256(msg).digest()


def test_populate_outputs_the_permutation(port):
    inputs = keccak.keccak_inputs(SIZE, SEED)
    assert port[2] == [keccak.keccak_f(row) for row in inputs]


def test_oracles_equal_reference(port, reference):
    ours, theirs = port[0].oracles.oracles, reference[0].oracles.oracles
    assert len(ours) == len(theirs) == 2089
    for o, j in zip(ours, theirs):
        for f in ORACLE_FIELDS:
            assert getattr(o, f) == getattr(j, f), (o.id, f)
    assert [(s.n_vars, s.oracle_ids) for s in port[0].constraint_sets] == \
        [(s.n_vars, s.oracle_ids) for s in reference[0].constraint_sets]
    assert len(port[0].constraint_sets[0].zero_constraints) == 600


def test_digest_equals_reference(port, reference):
    assert port[0].digest() == reference[0].digest()


def test_witness_equals_reference(port, reference):
    ours, theirs = port[1], reference[1]
    assert sorted(ours) == sorted(theirs)
    for oid, (lvl, d) in ours.items():
        jl, jd = theirs[oid]
        assert lvl == jl, oid
        assert np.array_equal(d.numpy().view(np.uint32), jd.view(np.uint32)), oid


def _flip_last_committed(oracles, witness, package_tower):
    """The committed columns of `witness` with bit 5 of the last committed
    column's first word flipped (a round-24 output lane)."""
    committed = oracles.committed_ids()
    out = {oid: witness[oid] for oid in committed}
    lvl, d = out[committed[-1]]
    assert lvl == package_tower.P1
    d = d.clone() if isinstance(d, torch.Tensor) else np.array(d)
    d[0] ^= 1 << 5
    out[committed[-1]] = (lvl, d)
    return out


def test_validate_witness(port):
    core, witness, _ = port
    validate_witness(core, dict(witness))
    bad = _flip_last_committed(core.oracles, witness, tower)
    with pytest.raises(ValueError, match="zero constraint"):
        validate_witness(core, bad)


def test_reference_validate_witness(reference):
    import jax.numpy as jnp
    from binius_tpu.constraint_system import witness as jwitness
    from binius_tpu.constraint_system.system import validate_witness as jvalidate
    from binius_tpu.fields import tower as jtower

    core = reference[0]
    witness = {oid: (lvl, jnp.asarray(d)) for oid, (lvl, d) in reference[1].items()}
    jvalidate(core, witness)
    bad = _flip_last_committed(core.oracles, {k: (lvl, np.asarray(d)) for k, (lvl, d)
                                              in witness.items()}, jtower)
    bad = {oid: (lvl, jnp.asarray(d)) for oid, (lvl, d) in bad.items()}
    for oid in range(len(core.oracles)):
        jwitness.materialize(core.oracles, bad, oid)
    with pytest.raises(ValueError, match="zero constraint"):
        jvalidate(core, bad)


def test_proof_matches_jax_digest(proof):
    size, n_bytes, sha = chip_smoke.GOLDEN_CIRCUITS["keccak"]
    assert size == SIZE
    assert (len(proof), hashlib.sha256(proof).hexdigest()) == (n_bytes, sha)


def test_verifier_accepts_and_rejects_a_flipped_byte(port, proof):
    core = port[0]
    csp.verify(core, proof, log_inv_rate=1, device="cpu")
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 1
    with pytest.raises((ValueError, EOFError)):
        csp.verify(core, bytes(bad), log_inv_rate=1, device="cpu")


def test_committed_columns_are_bit_packed(port):
    core, witness, _ = port
    levels = {witness[oid][0] for oid in core.oracles.committed_ids()}
    assert levels == {tower.P1}
    assert sum(o.variant == om.COMMITTED for o in core.oracles.oracles) == 625

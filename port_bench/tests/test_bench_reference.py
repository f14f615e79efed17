"""The reference against the program's proofs on the CPU, at small sizes:
it accepts them, and rejects a flipped byte, another statement's witness
and a proof made below the configuration's security."""

import random

import numpy as np
import pytest
import torch

import run as bench_run
from reference import binding, field, groestl, verifier

CPU = torch.device("cpu")
SIZES = {"u32_add_2e22": 6, "keccak_2e13": 1}


def _config(name):
    import json
    with open(bench_run.BENCH_DIR / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    return cfg, bench_run.load_file(bench_run.BENCH_DIR / "configs" / f"{name}.py", f"cfg_{name}")


@pytest.fixture(scope="module", params=sorted(SIZES))
def proven(request):
    from binius_tpu_torch.constraint_system import prove as csp
    name = request.param
    cfg, mod = _config(name)
    log = SIZES[name]
    stmt = mod.draw(log, 2**31 + 5, 0)
    system, witness = mod.build(stmt, log, CPU)
    proof = csp.prove(system, witness, log_inv_rate=1, device=CPU)
    ref = mod.reference_system(log, bytes.fromhex(cfg["system_digest"]))
    return cfg, mod, log, stmt, system, ref, proof


def test_system_is_the_programs(proven):
    """Oracle by oracle, the constraint set, and the digest."""
    cfg, _, _, _, system, ref, _ = proven
    assert system.digest().hex() == cfg["system_digest"]
    assert len(system.oracles.oracles) == len(ref.oracles)
    for o, r in zip(system.oracles.oracles, ref.oracles):
        assert (o.variant, o.n_vars, o.tower_level, tuple(o.inner)) == (r.kind, r.n_vars, r.level,
                                                                        r.inner)
        if r.kind == "shifted":
            assert (o.shift_offset, o.shift_block_bits, o.shift_variant) == r.shift
        if r.kind == "linear_combination":
            assert (o.lc_offset, tuple(o.lc_coeffs)) == r.lc
        if r.kind == "transparent":
            assert tuple(o.transparent.values) == r.values
    (cs,), (rs,) = system.constraint_sets, ref.constraint_sets
    assert (cs.n_vars, tuple(cs.oracle_ids)) == (rs.n_vars, rs.oracle_ids)
    rng = random.Random(3)
    vals = [rng.getrandbits(128) for _ in cs.oracle_ids]
    assert [c.evaluate_scalar(7, vals) for c in cs.zero_constraints] == \
        [e.evaluate(vals) for e in rs.exprs]
    assert [c.degree() for c in cs.zero_constraints] == [e.degree() for e in rs.exprs]


def test_accepts_and_binds(proven):
    cfg, mod, _, stmt, _, ref, proof = proven
    claims = verifier.verify(ref, proof, cfg["security_bits"], cfg["log_inv_rate"])
    cols, lw = mod.reference_columns(stmt)
    assert claims and binding.mismatches(claims, cols, lw, CPU) == 0


def test_witness_matches_the_programs(proven):
    """The reference's committed columns are the program's witness words."""
    _, mod, log, stmt, _, _, _ = proven
    _, witness = mod.build(stmt, log, CPU)
    cols, lw = mod.reference_columns(stmt)
    for oid, words in cols.items():
        lvl, data = witness[oid]
        got = data.numpy().view(np.uint32)
        want = words.astype("<u8").view(np.uint32) if lw == 6 else words.astype(np.uint32)
        assert np.array_equal(got, want), oid


@pytest.mark.parametrize("where", [0, 40, 0.5, -1])
def test_rejects_a_flipped_byte(proven, where):
    cfg, _, _, _, _, ref, proof = proven
    pos = int(where * len(proof)) if isinstance(where, float) else where % len(proof)
    bad = bytearray(proof)
    bad[pos] ^= 1
    with pytest.raises(verifier.Rejected):
        verifier.verify(ref, bytes(bad), cfg["security_bits"], cfg["log_inv_rate"])


def test_rejects_another_statement(proven):
    """A valid proof of another seed's statement fails the binding."""
    cfg, mod, log, _, _, ref, proof = proven
    claims = verifier.verify(ref, proof, cfg["security_bits"], cfg["log_inv_rate"])
    cols, lw = mod.reference_columns(mod.draw(log, 2**31 + 6, 0))
    assert binding.mismatches(claims, cols, lw, CPU) > 0


def test_rejects_a_proof_below_the_security():
    """The control: the program at 80 security bits, where the proof has
    FRI queries (u32_add at 2^12 rows), is held to 100 and fails."""
    from binius_tpu_torch.constraint_system import prove as csp
    cfg, mod = _config("u32_add_2e22")
    stmt = mod.draw(12, 11, 0)
    system, witness = mod.build(stmt, 12, CPU)
    ref = mod.reference_system(12, bytes.fromhex(cfg["system_digest"]))
    saved = csp.SECURITY_BITS
    try:
        csp.SECURITY_BITS = 80
        low = csp.prove(system, witness, log_inv_rate=1, device=CPU)
    finally:
        csp.SECURITY_BITS = saved
    assert verifier.fri_params(ref, 100, 1).arities, "no FRI queries at this size"
    with pytest.raises(verifier.Rejected):
        verifier.verify(ref, low, 100, 1)
    assert verifier.verify(ref, low, 80, 1)


def test_field_and_hash_against_the_program():
    from binius_tpu_torch.fields import scalar
    from binius_tpu_torch.hash import groestl as pg
    rng = random.Random(9)
    for _ in range(500):
        a, b = rng.getrandbits(128), rng.getrandbits(rng.choice([1, 8, 16, 32, 64, 128]))
        assert field.mul(a, b) == scalar.mul(7, a, b)
    x = rng.getrandbits(32) | 1
    assert field.invert(x, 5) == scalar.invert(5, x)
    for n in (0, 55, 64, 200):
        data = bytes(rng.getrandbits(8) for _ in range(n))
        assert groestl.digest(data) == pg.groestl256(data)
    pairs = np.frombuffer(bytes(rng.getrandbits(8) for _ in range(640)), np.uint8).reshape(10, 64)
    assert (groestl.compress_pairs(pairs) == pg.compress_pairs(pairs)).all()

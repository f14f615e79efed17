"""The port's evalcheck against the JAX package, on the CPU: claims on
shifted oracles (u32_add's logical-left carry shift of a bit-packed B1
column in blocks of 32, and a circular shift of a B8 column in one block
of 32, so that both reduce in one batched sumcheck and the JAX package
compiles few kernels) and on committed ones reduce to the same transcript bytes and the same
committed claims in both packages, and each package's verifier accepts the
port's proof with those claims; the shift indicators' partial multilinears
and evaluations, the shifted columns and the ported transparents equal the
JAX package's. Exact comparisons."""

import numpy as np
import pytest
import torch

from binius_tpu.constraint_system import oracle as jom
from binius_tpu.constraint_system import witness as jwitness
from binius_tpu.fields import tower as jtower
from binius_tpu.protocols import evalcheck as jevalcheck
from binius_tpu.protocols import shift_ind as jshift
from binius_tpu.transcript.transcript import ProverTranscript as JProver
from binius_tpu.transcript.transcript import VerifierTranscript as JVerifier
from binius_tpu_torch.constraint_system import oracle as om
from binius_tpu_torch.constraint_system import witness as cwitness
from binius_tpu_torch.convert import from_reference, to_reference
from binius_tpu_torch.fields import tower
from binius_tpu_torch.math import mle
from binius_tpu_torch.protocols import evalcheck, shift_ind
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript

torch.set_num_threads(1)  # the suite's test processes share the cores

LEVEL = 7
N_BITS = 8    # the B1 column: 2^8 bits in 8 packed words
N_B8 = 5      # the B8 column: 2^5 bytes


def _oracles(mod):
    s = mod.OracleSet()
    bits = s.add_committed(N_BITS, 0, "bits")
    carry = s.add_shifted(bits, 1, 5, "logical_left", "carry")
    b8 = s.add_committed(N_B8, 3, "bytes")
    rot = s.add_shifted(b8, 3, 5, "circular_left", "rot")
    return s, (bits, carry, b8, rot)


def _rand_point(rng, n):
    return tuple(int.from_bytes(rng.bytes(16), "little") for _ in range(n))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, 1 << (N_BITS - 5), dtype=np.uint64).astype(np.uint32)
    b8 = rng.integers(0, 256, 1 << N_B8, dtype=np.uint64).astype(np.uint32)
    oracles, (bits_id, carry_id, b8_id, rot_id) = _oracles(om)
    witness = {bits_id: (tower.P1, from_reference(words, "cpu")),
               b8_id: (3, from_reference(b8, "cpu"))}
    joracles, _ = _oracles(jom)
    jwit = {bits_id: (jtower.P1, jtower.from_numpy(0, words)),
            b8_id: (3, jtower.from_numpy(3, b8))}
    for oid in (carry_id, rot_id):
        cwitness.materialize(oracles, witness, oid)
        jwitness.materialize(joracles, jwit, oid)

    def value(oid, n, point):
        lvl, d = tower.resolve_p1(*witness[oid])
        eq = mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, list(point), "cpu"))
        return tower.to_ints(LEVEL, mle.batched_evaluate_partial_high(lvl, d[None], n, eq, 0)[1]
                             .reshape(-1, 4))[0]

    p1, p2 = _rand_point(rng, N_BITS), _rand_point(rng, N_B8)
    specs = [(carry_id, N_BITS, p1), (bits_id, N_BITS, p1), (rot_id, N_B8, p2),
             (carry_id, N_BITS, p1)]   # a duplicate claim is dropped
    claims = [evalcheck.EvalcheckClaim(oid, pt, value(oid, n, pt)) for oid, n, pt in specs]
    jclaims = [jevalcheck.EvalcheckClaim(c.oracle_id, c.point, c.eval) for c in claims]
    return oracles, witness, claims, joracles, jwit, jclaims


def test_shifted_columns_match_reference(setup):
    oracles, witness, _, _, jwit, _ = setup
    for oid in witness:
        assert witness[oid][0] == jwit[oid][0]
        assert np.array_equal(to_reference(witness[oid][1]), np.asarray(jwit[oid][1]))


def test_evalcheck_matches_reference(setup):
    oracles, witness, claims, joracles, jwit, jclaims = setup
    pt, jt = ProverTranscript(), JProver()
    out = evalcheck.prove(oracles, witness, claims, pt)
    jout = jevalcheck.prove(joracles, jwit, jclaims, jt)
    proof = pt.finalize()
    assert proof == jt.finalize()
    assert [(c.oracle_id, c.point, c.eval) for c in out] == [
        (c.oracle_id, c.point, c.eval) for c in jout]
    ver = evalcheck.verify(oracles, claims, VerifierTranscript(proof))
    assert [(c.oracle_id, c.point, c.eval) for c in ver] == [
        (c.oracle_id, c.point, c.eval) for c in out]
    jver = jevalcheck.verify(joracles, jclaims, JVerifier(proof))
    assert [(c.oracle_id, c.point, c.eval) for c in jver] == [
        (c.oracle_id, c.point, c.eval) for c in out]


def test_evalcheck_rejects_a_wrong_claim(setup):
    oracles, witness, claims, *_ = setup
    pt = ProverTranscript()
    evalcheck.prove(oracles, witness, claims, pt)
    bad = [evalcheck.EvalcheckClaim(claims[0].oracle_id, claims[0].point, claims[0].eval ^ 1),
           *claims[1:3]]
    with pytest.raises(ValueError):
        evalcheck.verify(oracles, bad, VerifierTranscript(pt.finalize()))


SHIFTS = [("logical_left", 1), ("logical_right", 2), ("circular_left", 3)]


@pytest.fixture(scope="module")
def indicators():
    """The JAX package's partial multilinears of the three shifts at b = 5,
    in one batch (one compile), and their points."""
    rng = np.random.default_rng(9)
    xs = [list(_rand_point(rng, 5)) for _ in SHIFTS]
    want = jshift.partial_mle_batch([v for v, _ in SHIFTS], 5, [o for _, o in SHIFTS], xs)
    return xs, np.asarray(want)


@pytest.mark.parametrize("i", range(len(SHIFTS)), ids=[v for v, _ in SHIFTS])
def test_shift_indicator_matches_reference(indicators, i):
    variant, o = SHIFTS[i]
    b = 5
    xs, want = indicators
    x = xs[i]
    rng = np.random.default_rng(i)
    y = list(_rand_point(rng, b))
    got = shift_ind.partial_mle_batch([variant], b, [o], [x], "cpu")
    assert np.array_equal(to_reference(got)[0], want[i])
    assert shift_ind.evaluate_scalar(variant, b, o, x, y) == jshift.evaluate_scalar(
        variant, b, o, x, y)
    vals = [int(v) for v in rng.integers(0, 256, 1 << (b + 1))]
    assert tower.to_ints(3, shift_ind.apply_shift_device(
        3, variant, b, o, tower.from_ints(3, vals, "cpu"))) == jshift.apply_shift_ints(
        variant, b, o, vals)


@pytest.mark.parametrize("kind", ["constant", "eq_ind"])
def test_transparents_match_reference(kind):
    from binius_tpu.protocols import transparent as jtransparent
    from binius_tpu_torch.protocols import transparent

    rng = np.random.default_rng(4)
    pt = list(_rand_point(rng, 3))
    args = (3, 0x1234, 4) if kind == "constant" else (tuple(_rand_point(rng, 3)),)
    cls = "Constant" if kind == "constant" else "EqIndTransparent"
    ours, ref = getattr(transparent, cls)(*args), getattr(jtransparent, cls)(*args)
    assert ours.evaluate_scalar(pt) == ref.evaluate_scalar(pt)
    lvl, data = ours.mle("cpu")
    rlvl, rdata = ref.mle()
    assert lvl == rlvl and np.array_equal(to_reference(data), np.asarray(rdata))


def test_composite_oracle_matches_reference_verifier():
    """A composite oracle (an eq-indicator sumcheck folding low to high):
    its materialized column equals the JAX package's, and the port's proof
    reads back to the same committed claims in both packages' verifiers (the JAX prover is not run: its compile costs
    more than the rest of this file)."""
    from binius_tpu.math import arith as jarith
    from binius_tpu_torch.math import arith

    rng = np.random.default_rng(6)
    cols = [rng.integers(0, 256, 1 << N_B8, dtype=np.uint64).astype(np.uint32)
            for _ in range(2)]

    def oracles(mod, A):
        s = mod.OracleSet()
        ids = [s.add_committed(N_B8, 3, f"c{i}") for i in range(2)]
        V = A.ArithExpr.var
        comp = s.add_composite(N_B8, ids, V(0) * V(1) + V(0) * A.ArithExpr.const(0x35, 3))
        return s, ids, comp

    ours, ids, comp = oracles(om, arith)
    ref, _, _ = oracles(jom, jarith)
    witness = {i: (3, from_reference(c, "cpu")) for i, c in zip(ids, cols)}
    jwit = {i: (3, jtower.from_numpy(3, c)) for i, c in zip(ids, cols)}
    cwitness.materialize(ours, witness, comp)
    jwitness.materialize(ref, jwit, comp)
    assert witness[comp][0] == jwit[comp][0]
    assert np.array_equal(to_reference(witness[comp][1]), np.asarray(jwit[comp][1]))
    point = _rand_point(rng, N_B8)
    eq = mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, list(point), "cpu"))
    lvl, data = witness[comp]   # the composite closes in B8: stored there
    value = tower.to_ints(LEVEL, mle.batched_evaluate_partial_high(
        lvl, data[None], N_B8, eq, 0)[1].reshape(-1, 4))[0]
    pt = ProverTranscript()
    out = evalcheck.prove(ours, witness, [evalcheck.EvalcheckClaim(comp, point, value)], pt)
    proof = pt.finalize()
    ver = evalcheck.verify(ours, [evalcheck.EvalcheckClaim(comp, point, value)],
                           VerifierTranscript(proof))
    jver = jevalcheck.verify(ref, [jevalcheck.EvalcheckClaim(comp, point, value)],
                             JVerifier(proof))
    want = [(c.oracle_id, c.point, c.eval) for c in out]
    assert [(c.oracle_id, c.point, c.eval) for c in ver] == want
    assert [(c.oracle_id, c.point, c.eval) for c in jver] == want

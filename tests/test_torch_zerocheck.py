"""The port's univariate-skip zerocheck against the JAX package, on the
CPU. On the golden u32_add claim (8 variables, 7 skipped rounds, one claim
of two compositions of degree 2) the port's transcript has the bytes of
the JAX package's `univariate_zerocheck.batch_prove` (pinned by their
sha256 below, computed with the JAX package on the CPU: its prover
compiles for about 45 s there, so it is not rerun here), and the JAX
package's `batch_verify` reads it back to the port's reduced claims. Two
claims of unequal degrees and sizes (a lower-degree claim extended to the
batch's domain, a smaller claim high-padded), and a claim over B128
multilinears, go the same way through both verifiers. The skip count, the Lagrange evaluations and `OddInterpolate`
equal the JAX package's. A claim of 8 compositions of two shapes gives the
same round evaluations with its compositions stacked by shape as one at a
time, in stage 1 and in the stage-2 prover, and verifies in both
packages. Exact comparisons."""

import hashlib
import random

import numpy as np
import pytest
import torch

from binius_tpu.math import arith as jarith
from binius_tpu.math import univariate as juni
from binius_tpu.ntt import additive_ntt as jntt
from binius_tpu.ntt import odd_interpolate as jodd
from binius_tpu.protocols.sumcheck import univariate_zerocheck as juzc
from binius_tpu.protocols.sumcheck import zerocheck as jzc
from binius_tpu.transcript.transcript import VerifierTranscript as JVerifier
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.fields import tower
from binius_tpu_torch.m3.gadgets import arith as gadgets
from binius_tpu_torch.math import arith, univariate
from binius_tpu_torch.ntt import additive_ntt, odd_interpolate
from binius_tpu_torch.protocols.sumcheck import common
from binius_tpu_torch.protocols.sumcheck import univariate_zerocheck as uzc
from binius_tpu_torch.protocols.sumcheck import zerocheck
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript

torch.set_num_threads(1)  # the suite's test processes share the cores

# sha256 of the JAX package's batch_prove transcript on the golden claim
GOLDEN_ZEROCHECK = "4ca998c8f433079c03498052e48d0067bd2196a222d562d7608449106cc52ab0"


def _jax_claims(claims):
    """The port's zerocheck claims rebuilt with the JAX package's types."""
    def expr(e):
        if e.op == "var":
            return jarith.ArithExpr.var(e.value)
        if e.op == "const":
            return jarith.ArithExpr.const(e.value, e.level)
        args = [expr(a) for a in e.args]
        if e.op == "add":
            return jarith.ArithExpr("add", tuple(args))
        if e.op == "mul":
            return jarith.ArithExpr("mul", tuple(args))
        return jarith.ArithExpr("pow", tuple(args), e.value)
    return [jzc.ZerocheckClaim(c.n_vars, c.n_multilinears,
                               tuple(jarith.CompositionPoly(expr(p.expr), p.n_vars)
                                     for p in c.compositions)) for c in claims]


def _check_verifiers(claims, proof, skip, out):
    ver = uzc.batch_verify(claims, VerifierTranscript(proof), skip)
    jver = juzc.batch_verify(_jax_claims(claims), JVerifier(proof), skip)
    for v in (ver, jver):
        assert v.multilinear_evals == out.multilinear_evals
        assert v.eval_points == out.eval_points
        assert v.skipped_challenges == out.skipped_challenges


@pytest.fixture(scope="module")
def golden():
    rng = random.Random(42)
    xs = [rng.getrandbits(32) for _ in range(8)]
    ys = [rng.getrandbits(32) for _ in range(8)]
    core, witness = gadgets.u32_add_system(3, xs, ys, "cpu")
    sets, claims = csp._zerocheck_claims(core, ascending=True)
    mls = [[witness[oid] for oid in s.oracle_ids] for s in sets]
    pt = ProverTranscript()
    out = uzc.batch_prove(claims, mls, pt, 7)
    return claims, pt.finalize(), out


def test_golden_claim_matches_reference(golden):
    claims, proof, out = golden
    assert uzc.compute_skip_rounds(claims) == juzc.compute_skip_rounds(_jax_claims(claims)) == 7
    assert len(proof) == 2496
    assert hashlib.sha256(proof).hexdigest() == GOLDEN_ZEROCHECK
    _check_verifiers(claims, proof, 7, out)


def test_golden_claim_rejects_a_flipped_byte(golden):
    claims, proof, _ = golden
    bad = bytearray(proof)
    bad[17] ^= 1
    with pytest.raises(ValueError):
        uzc.batch_verify(claims, VerifierTranscript(bytes(bad)), 7)


def test_unequal_claims_match_reference():
    """A 5-variable claim of degree 3 and a 3-variable claim of degree 2
    (B1 and B8 multilinears) at 4 skipped rounds."""
    rng = np.random.default_rng(11)
    V = arith.ArithExpr.var

    def cols(n, level, k):
        vals = [rng.integers(0, 1 << (1 << level), 1 << n, dtype=np.uint64) for _ in range(k)]
        return vals

    a = cols(3, 3, 2)
    small = zerocheck.ZerocheckClaim(3, 3, (arith.CompositionPoly(V(0) * V(1) + V(2), 3),))
    b = cols(5, 0, 3)
    big = zerocheck.ZerocheckClaim(5, 4, (arith.CompositionPoly(V(0) * V(1) * V(2) + V(3), 4),
                                          arith.CompositionPoly(V(0) + V(0), 4)))
    prod_a = [tower.to_ints(3, tower.mul(3, tower.from_ints(3, list(a[0]), "cpu"),
                                         tower.from_ints(3, list(a[1]), "cpu")))]
    mls_small = [(3, tower.from_ints(3, list(c), "cpu")) for c in a] + [
        (3, tower.from_ints(3, prod_a[0], "cpu"))]
    abc = (b[0] & b[1] & b[2]).astype(np.uint64)
    mls_big = [(0, tower.from_ints(0, list(c), "cpu")) for c in b] + [
        (0, tower.from_ints(0, list(abc), "cpu"))]
    claims = [small, big]
    skip = 4
    pt = ProverTranscript()
    out = uzc.batch_prove(claims, [mls_small, mls_big], pt, skip)
    _check_verifiers(claims, pt.finalize(), skip, out)


def test_lagrange_evals_match_reference():
    points = juzc._domain_points(2 << 7)
    assert points == uzc._domain_points(2 << 7)
    z = int.from_bytes(np.random.default_rng(1).bytes(16), "little")
    want = [int(r[0]) | (int(r[1]) << 32) | (int(r[2]) << 64) | (int(r[3]) << 96)
            for r in juni.lagrange_evals_np(points, z)]
    assert univariate.lagrange_evals_np(points, z) == want
    assert univariate.lagrange_evals_np(points, points[5]) == [int(i == 5) for i in
                                                               range(len(points))]
    small = points[:6]
    assert univariate.lagrange_evals_np(small, z) == juni.EvaluationDomain(
        7, small).lagrange_evals(7, z)


@pytest.mark.parametrize("d,ell", [(3, 2), (5, 3)])
def test_odd_interpolate_matches_reference(d, ell):
    dom, jdom = additive_ntt.NTTDomain.create(7, 6), jntt.NTTDomain.create(7, 6)
    oi = odd_interpolate.OddInterpolate.create(dom, d, ell, 6 - ell)
    joi = jodd.OddInterpolate.create(jdom, d, ell, 6 - ell)
    assert oi.vandermonde_inverse == joi.vandermonde_inverse
    vals = [int.from_bytes(np.random.default_rng(d).bytes(16), "little") >> i
            for i in range(d << ell)]
    assert oi.inverse_transform(vals) == joi.inverse_transform(vals)


def test_b128_claim_matches_reference():
    """B128 multilinears and a B8 constant: stage 1 runs at B128 (its NTT
    scales B128 data by B8 twiddles), 3 of 5 variables skipped."""
    rng = np.random.default_rng(3)
    V = arith.ArithExpr.var
    n = 5
    a, b = ([int.from_bytes(rng.bytes(16), "little") for _ in range(1 << n)] for _ in range(2))
    A, B = tower.from_ints(7, a, "cpu"), tower.from_ints(7, b, "cpu")
    claim = zerocheck.ZerocheckClaim(n, 3, (arith.CompositionPoly(
        V(0) * V(1) + V(2) + arith.ArithExpr.const(0x77, 3) * (V(2) + V(2)), 3),))
    pt = ProverTranscript()
    out = uzc.batch_prove([claim], [[(7, A), (7, B), (7, tower.mul(7, A, B))]], pt, 3)
    _check_verifiers([claim], pt.finalize(), 3, out)


def _two_shape_claim(n: int, level: int, seed: int):
    """A claim of 8 compositions of two shapes (5 of V(a)*V(b) + V(c), 3 of
    V(a) + (1 + V(b))*V(c) + V(d), interleaved, their variables in several
    orders) over 6 random multilinears of `level` with n variables."""
    rng = np.random.default_rng(seed)
    V = arith.ArithExpr.var
    spec = [(0, 1, 2), (3, 4, 5), (0, 1, 2, 3), (1, 0, 3), (4, 5, 0, 1), (5, 2, 4), (2, 1, 0),
            (2, 3, 5, 4)]
    comps = []
    for vs in spec:
        if len(vs) == 4:
            a, b, c, d = vs
            e = V(a) + (arith.ArithExpr.const(1) + V(b)) * V(c) + V(d)
        else:
            a, b, c = vs
            e = V(a) * V(b) + V(c)
        comps.append(arith.CompositionPoly(e, 6))
    mls = [(level, tower.from_ints(level, [int(v) for v in rng.integers(
        0, 1 << min(1 << level, 62), 1 << n, dtype=np.uint64)], "cpu")) for _ in range(6)]
    return zerocheck.ZerocheckClaim(n, 6, tuple(comps)), mls


@pytest.mark.parametrize("n,level", [(8, 0), (7, 3), (8, 5)])
def test_stacked_stage1_equals_one_at_a_time(n, level):
    """Stage 1's round evaluations of a claim's compositions, evaluated as
    one expression per shape over a stacked gather, equal each composition
    evaluated on its own."""
    from binius_tpu_torch.protocols.sumcheck import prove as sc_prove

    zc, mls = _two_shape_claim(n, level, n + level)
    groups = sc_prove._group_comp_specs(uzc._compact_compositions(zc))
    assert sorted(len(g[2]) for g in groups) == [3, 5]
    k = uzc.compute_skip_rounds([zc])
    d = uzc._max_degree(zc)
    dom_log = max(1, ((d << k) - 1).bit_length())
    rng = random.Random(n)
    eq_pt = [rng.getrandbits(128) for _ in range(n - k)]
    stacked = uzc._claim_round_evals(zc, mls, eq_pt, k, d, dom_log)
    single = torch.cat([uzc._claim_round_evals(zerocheck.ZerocheckClaim(n, 6, (c,)), mls, eq_pt,
                                               k, d, dom_log) for c in zc.compositions])
    assert stacked.shape == (8, (d - 1) << k, 4)
    assert torch.equal(stacked, single)


def test_stacked_stage2_equals_one_at_a_time():
    """The regular sumcheck prover's round polynomials of 8 compositions of
    two shapes (grouped, and mixed on the device before one interpolation)
    equal each composition's prover on its own, round after round."""
    from binius_tpu_torch.protocols.sumcheck import prove as sc_prove
    from binius_tpu_torch.protocols.sumcheck.common import CompositeSumClaim, SumcheckClaim

    zc, mls = _two_shape_claim(6, 7, 3)
    claim = SumcheckClaim(6, 6, tuple(CompositeSumClaim(c, 0) for c in zc.compositions))
    stacked = sc_prove.RegularSumcheckProver(claim, mls, order_high=True)
    singles = [sc_prove.RegularSumcheckProver(SumcheckClaim(6, 6, (cs,)), mls, order_high=True)
               for cs in claim.composite_sums]
    rng = random.Random(5)
    weights = [rng.getrandbits(128) for _ in range(8)]
    for _ in range(3):
        polys = [p.compute_mixed_round_poly([1]) for p in singles]
        for j in range(8):
            unit = [int(i == j) for i in range(8)]
            assert stacked.compute_mixed_round_poly(unit) == polys[j]
        mixed = []
        for coeffs, w in zip(polys, weights):
            mixed = common.add_coeffs(mixed, common.scale_coeffs(coeffs, w))
        assert stacked.compute_mixed_round_poly(weights) == mixed
        ch = rng.getrandbits(128)
        for p in [stacked, *singles]:
            p.fold(ch)


def test_many_composition_claim_verifies_in_both_packages():
    """A claim of 8 compositions of two shapes whose multilinears satisfy
    them: the port's proof reads back through the JAX package's verifier."""
    V = arith.ArithExpr.var
    rng = np.random.default_rng(21)
    n = 8
    x = [rng.integers(0, 2, 1 << n, dtype=np.uint64) for _ in range(4)]
    cols = x + [x[0] & x[1], x[0] ^ ((1 ^ x[2]) & x[3])]   # a*b, a + (1 + c)*d
    comps = []
    for i in range(8):
        if i % 2:
            comps.append(arith.CompositionPoly(V(0) + (arith.ArithExpr.const(1) + V(2)) * V(3)
                                               + V(5), 6))
        else:
            comps.append(arith.CompositionPoly(V(0) * V(1) + V(4), 6))
    zc = zerocheck.ZerocheckClaim(n, 6, tuple(comps))
    mls = [(0, tower.from_ints(0, [int(v) for v in c], "cpu")) for c in cols]
    skip = uzc.compute_skip_rounds([zc])
    pt = ProverTranscript()
    out = uzc.batch_prove([zc], [mls], pt, skip)
    _check_verifiers([zc], pt.finalize(), skip, out)

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
equal the JAX package's. Exact comparisons."""

import hashlib
import random

import numpy as np
import pytest

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
from binius_tpu_torch.protocols.sumcheck import univariate_zerocheck as uzc
from binius_tpu_torch.protocols.sumcheck import zerocheck
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript

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

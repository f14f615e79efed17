"""The port's sumcheck engine against the JAX package on small claims, on
the CPU: `batch_prove` with `RegularSumcheckProver` in both folding orders
(a composition with a sum, a product and a constant), the eq-indicator
zerocheck (skip = 0, B1 values),
`BatchedBivariateSumcheckProver` beside a larger claim (rear-loaded
activation), and the prestacked `BivariateSumcheckProver` folding high to
low: the transcript bytes, challenges and final evaluations are equal, and
the port's `batch_verify` accepts the port's proof with the same reduced
claims. Exact comparisons. The claims have 2 variables (the rear-loaded
batch 3), so that the JAX package compiles few kernels on the CPU: every
distinct composition and shape costs it a compile of seconds; the
composition algebra of every node kind is held on 8 rows without JAX
compiles (`test_arith_expr_matches_reference`)."""

import numpy as np
import pytest

from binius_tpu.fields import tower as jtower
from binius_tpu.math import arith as jarith
from binius_tpu.protocols.sumcheck import common as jcommon
from binius_tpu.protocols.sumcheck import prove as jprove
from binius_tpu.protocols.sumcheck import zerocheck as jzc
from binius_tpu.transcript.transcript import ProverTranscript as JProver
from binius_tpu_torch.fields import scalar, tower
from binius_tpu_torch.math import arith
from binius_tpu_torch.protocols.sumcheck import common, verify, zerocheck
from binius_tpu_torch.protocols.sumcheck import prove as sc_prove
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript

LEVEL = 7
MASKS = {0: 1, 3: 0xFF, 7: (1 << 128) - 1}


def _rand(rng, n, level):
    return [int.from_bytes(rng.bytes(16), "little") & MASKS[level] for _ in range(n)]


def _exprs(A):
    """The same composition built with either package's ArithExpr."""
    V = A.ArithExpr.var
    return [(V(0) + A.ArithExpr.const(0x1234, 4)) * V(1) + V(2)]


def _sums(exprs, cols):
    """Hypercube sums of each composition on host ints."""
    out = []
    for e in exprs:
        acc = 0
        for row in zip(*cols):
            acc ^= e.evaluate_scalar(LEVEL, list(row))
        out.append(acc)
    return out


def _claim(mod, C, exprs, n_vars, n_mls, sums):
    return mod.SumcheckClaim(n_vars, n_mls, tuple(
        mod.CompositeSumClaim(C(e, n_mls), s) for e, s in zip(exprs, sums)))


def _both(level, vals):
    """(JAX array, port tensor) of the same elements."""
    return jtower.from_ints(level, vals), tower.from_ints(level, vals, "cpu")


@pytest.fixture(scope="module")
def regular_inputs():
    rng = np.random.default_rng(5)
    n = 2
    levels = (7, 7, 7)
    cols = [_rand(rng, 1 << n, lvl) for lvl in levels]
    sums = _sums(_exprs(arith), cols)
    return n, levels, cols, sums


@pytest.mark.parametrize("order_high", [False, True])
def test_regular_prover_matches_reference(regular_inputs, order_high):
    n, levels, cols, sums = regular_inputs
    jclaim = _claim(jcommon, jarith.CompositionPoly, _exprs(jarith), n, 3, sums)
    claim = _claim(common, arith.CompositionPoly, _exprs(arith), n, 3, sums)
    pairs = [_both(lvl, c) for lvl, c in zip(levels, cols)]
    jt, pt = JProver(), ProverTranscript()
    jout = jprove.batch_prove([jprove.RegularSumcheckProver(
        jclaim, [(lvl, j) for lvl, (j, _) in zip(levels, pairs)], order_high)], jt)
    out = sc_prove.batch_prove([sc_prove.RegularSumcheckProver(
        claim, [(lvl, p) for lvl, (_, p) in zip(levels, pairs)], order_high)], pt)
    proof = pt.finalize()
    assert proof == jt.finalize()
    assert out.challenges == jout.challenges
    assert out.multilinear_evals == jout.multilinear_evals
    ver = verify.batch_verify([claim], VerifierTranscript(proof), order_high)
    assert ver.challenges == out.challenges
    assert ver.multilinear_evals == out.multilinear_evals


def test_eq_indicator_zerocheck_matches_reference():
    """The skip = 0 zerocheck: u32_add's sum constraint on 2^2 B1 rows."""
    rng = np.random.default_rng(6)
    n = 2
    x, y, c = (_rand(rng, 1 << n, 0) for _ in range(3))
    z = [a ^ b ^ d for a, b, d in zip(x, y, c)]
    cols = [x, y, c, z]

    def claim(mod, A):
        V = A.ArithExpr.var
        return mod.ZerocheckClaim(n, 4, (A.CompositionPoly(V(0) + V(1) + V(2) + V(3), 4),))

    # the B1 values embedded in B128 (the same integers, so the same bytes):
    # one kernel shape for the JAX package to compile in every round
    pairs = [_both(LEVEL, col) for col in cols]
    jt, pt = JProver(), ProverTranscript()
    jout = jzc.batch_prove([claim(jzc, jarith)], [[(LEVEL, j) for j, _ in pairs]], jt)
    out = zerocheck.batch_prove([claim(zerocheck, arith)], [[(LEVEL, p) for _, p in pairs]],
                                pt)
    proof = pt.finalize()
    assert proof == jt.finalize()
    assert out.multilinear_evals == jout.multilinear_evals
    ver = zerocheck.batch_verify([claim(zerocheck, arith)], VerifierTranscript(proof))
    assert ver.multilinear_evals == out.multilinear_evals


def _product_claims(mod, C, vals, n, k):
    claims = []
    for i in range(k):
        a, b = vals[2 * i], vals[2 * i + 1]
        s = 0
        for u, v in zip(a, b):
            s ^= scalar.mul(LEVEL, u, v)
        claims.append(mod.SumcheckClaim(n, 2, (mod.CompositeSumClaim(
            C(mod_expr(C) * mod_expr(C, 1), 2), s),)))
    return claims


def mod_expr(C, i=0):
    A = jarith if C is jarith.CompositionPoly else arith
    return A.ArithExpr.var(i)


def test_batched_bivariate_beside_a_larger_claim_matches_reference(regular_inputs):
    """A 2-variable regular claim, then three 1-variable product claims in
    one batched prover (activated a round in), folding low to high."""
    n, levels, cols, sums = regular_inputs
    rng = np.random.default_rng(7)
    k, nb = 3, 1
    vals = [_rand(rng, 1 << nb, 7) for _ in range(2 * k)]
    flat = [v for row in vals for v in row]
    jstack = jtower.from_ints(LEVEL, flat).reshape(2 * k, 1 << nb, 4)
    stack = tower.from_ints(LEVEL, flat, "cpu").reshape(2 * k, 1 << nb, 4)
    pairs = [_both(lvl, c) for lvl, c in zip(levels, cols)]
    jt, pt = JProver(), ProverTranscript()
    jout = jprove.batch_prove([
        jprove.RegularSumcheckProver(_claim(jcommon, jarith.CompositionPoly, _exprs(jarith), n,
                                            3, sums), [(lvl, j) for lvl, (j, _) in
                                                       zip(levels, pairs)], False),
        jprove.BatchedBivariateSumcheckProver(
            _product_claims(jcommon, jarith.CompositionPoly, vals, nb, k), jstack)], jt)
    claims_b = _product_claims(common, arith.CompositionPoly, vals, nb, k)
    reg = _claim(common, arith.CompositionPoly, _exprs(arith), n, 3, sums)
    out = sc_prove.batch_prove([
        sc_prove.RegularSumcheckProver(reg, [(lvl, p) for lvl, (_, p) in zip(levels, pairs)],
                                       False),
        sc_prove.BatchedBivariateSumcheckProver(claims_b, stack)], pt)
    proof = pt.finalize()
    assert proof == jt.finalize()
    assert out.multilinear_evals == jout.multilinear_evals
    ver = verify.batch_verify([reg, *claims_b], VerifierTranscript(proof), False)
    assert ver.multilinear_evals == out.multilinear_evals


def test_prestacked_bivariate_high_to_low_matches_reference():
    """The zerocheck's stage-3 shape: products of every row with the last,
    one row read by every composite, folding high to low."""
    rng = np.random.default_rng(8)
    n, m = 2, 4
    vals = [_rand(rng, 1 << n, 7) for _ in range(m + 1)]
    flat = [v for row in vals for v in row]

    def claim(mod, A):
        comps = []
        for i in range(m):
            s = 0
            for u, v in zip(vals[i], vals[m]):
                s ^= scalar.mul(LEVEL, u, v)
            comps.append(mod.CompositeSumClaim(A.CompositionPoly(
                A.ArithExpr.var(i) * A.ArithExpr.var(m), m + 1), s))
        return mod.SumcheckClaim(n, m + 1, tuple(comps))

    jt, pt = JProver(), ProverTranscript()
    jout = jprove.batch_prove([jprove.BivariateSumcheckProver(
        claim(jcommon, jarith), prestacked=jtower.from_ints(LEVEL, flat).reshape(m + 1, -1, 4),
        order_high=True)], jt)
    out = sc_prove.batch_prove([sc_prove.BivariateSumcheckProver(
        claim(common, arith), prestacked=tower.from_ints(LEVEL, flat, "cpu").reshape(
            m + 1, -1, 4), order_high=True)], pt)
    proof = pt.finalize()
    assert proof == jt.finalize()
    assert out.multilinear_evals == jout.multilinear_evals
    ver = verify.batch_verify([claim(common, arith)], VerifierTranscript(proof), True)
    assert ver.multilinear_evals == out.multilinear_evals


def test_arith_expr_matches_reference():
    """Degrees, levels, variables, tokens and host and tensor evaluation."""
    V, J = arith.ArithExpr.var, jarith.ArithExpr.var
    ours = _exprs(arith) + [(V(0) + V(2)) ** 2 * V(1) + V(0) * V(1),
                            V(2) * V(2) * V(0) ** 3 + 5]
    ref = _exprs(jarith) + [(J(0) + J(2)) ** 2 * J(1) + J(0) * J(1),
                            J(2) * J(2) * J(0) ** 3 + 5]
    rng = np.random.default_rng(9)
    rows = [_rand(rng, 8, 7) for _ in range(3)]
    for e, r in zip(ours, ref):
        assert (e.degree(), e.binary_tower_level(), e.vars_used(), e.n_vars()) == (
            r.degree(), r.binary_tower_level(), r.vars_used(), r.n_vars())
        assert e.serialize_tokens() == r.serialize_tokens()
        remap = {0: 2, 1: 0, 2: 1}
        assert e.remap_vars(remap).serialize_tokens() == r.remap_vars(remap).serialize_tokens()
        got = tower.to_ints(LEVEL, e.evaluate(LEVEL, [tower.from_ints(LEVEL, c, "cpu")
                                                       for c in rows]))
        want = [r.evaluate_scalar(LEVEL, list(row)) for row in zip(*rows)]
        assert got == want == [e.evaluate_scalar(LEVEL, list(row)) for row in zip(*rows)]

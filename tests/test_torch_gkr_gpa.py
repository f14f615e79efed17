"""The port's grand-product argument, product check and new transparents
on the CPU against the JAX package's.

The same numpy values (B128, from a seed) go to both packages:
`GrandProductWitness` stacks of instances of 2^3-2^6 values, layer by
layer against the JAX package's `_pairwise_product` tree; the port's
`gkr_gpa.batch_prove` over instances of two sizes read by the JAX
package's `batch_verify` (host code) and the port's own, with equal
points and evaluations, and the reduced claims holding on the inputs; a
wrong product rejected by both; the stacked layer prover
(`EqStackedSumcheckProver`, in one chunk and in chunks of a few claims)
byte-equal to one `RegularSumcheckProver` per claim. `prodcheck`'s layers
against `ProductCircuitLayers`, its proof read by the JAX verifier.
`StepDown`, `StepUp` and `StructuredArith` (the bit-AND and increment
tables' merged expressions): `evaluate_scalar` and `mle` against the JAX
package's. `ArithExpr.evaluate`, which the stacked rounds run, frees its
temporaries without the cyclic collector (fault C2). Exact comparisons
throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from binius_tpu.fields import tower as jtower
from binius_tpu.m3.gadgets import indexed_lookup as jlookup
from binius_tpu.protocols import gkr_gpa as jgpa
from binius_tpu.protocols import prodcheck as jprod
from binius_tpu.protocols import transparent as jtp
from binius_tpu.transcript.transcript import VerifierTranscript as JVerifier
from binius_tpu_torch.fields import tower
from binius_tpu_torch.m3.gadgets import indexed_lookup
from binius_tpu_torch.math import mle
from binius_tpu_torch.math.arith import ArithExpr, CompositionPoly
from binius_tpu_torch.protocols import gkr_gpa, prodcheck, transparent
from binius_tpu_torch.protocols.sumcheck import prove as sc_prove
from binius_tpu_torch.protocols.sumcheck.common import CompositeSumClaim, SumcheckClaim
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript


def _values(m: int, n_vars: int, seed: int) -> np.ndarray:
    """(m, 2^n, 4) uint32 limbs of non-zero B128 values."""
    a = np.random.default_rng(seed).integers(0, 1 << 32, (m, 1 << n_vars, 4)).astype(np.uint32)
    a[..., 0] |= 1
    return a


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


@pytest.mark.parametrize("n_vars,m", [(3, 1), (4, 3), (5, 2), (6, 4)])
def test_witness_layers_match_reference(n_vars, m):
    vals = _values(m, n_vars, n_vars)
    ours = gkr_gpa.GrandProductWitness.compute(n_vars, _t(vals))
    assert len(ours.layers) == n_vars + 1
    for i in range(m):
        theirs = jgpa.GrandProductWitness.compute(n_vars, jnp.asarray(vals[i]))
        for k in range(n_vars + 1):
            assert np.array_equal(ours.layers[k][i].numpy().view(np.uint32),
                                  np.asarray(theirs.layers[k]).view(np.uint32)), (i, k)
        assert ours.products[i] == theirs.product


def _instances():
    """Five instances: three of 5 variables, two of 3 (mixed sizes)."""
    big, small = _values(3, 5, 11), _values(2, 3, 12)
    wits = [gkr_gpa.GrandProductWitness.compute(5, _t(big)),
            gkr_gpa.GrandProductWitness.compute(3, _t(small))]
    claims = [gkr_gpa.GrandProductClaim(w.n_vars, p) for w in wits for p in w.products]
    inputs = [(5, big[i]) for i in range(3)] + [(3, small[i]) for i in range(2)]
    return claims, wits, inputs


@pytest.mark.parametrize("chunk", [sc_prove.STACKED_CHUNK_ELEMS, 16])
def test_batch_prove_read_by_reference(chunk, monkeypatch):
    monkeypatch.setattr(sc_prove, "STACKED_CHUNK_ELEMS", chunk)
    claims, wits, inputs = _instances()
    t = ProverTranscript()
    out = gkr_gpa.batch_prove(claims, wits, t)
    proof = t.finalize()
    vt = JVerifier(proof)
    theirs = jgpa.batch_verify([jgpa.GrandProductClaim(c.n_vars, c.product) for c in claims], vt)
    vt.finalize()
    vt = VerifierTranscript(proof)
    again = gkr_gpa.batch_verify(claims, vt)
    vt.finalize()
    assert out.eval_points == theirs.eval_points == again.eval_points
    assert out.evals == theirs.evals == again.evals
    for (n, data), pt, ev in zip(inputs, out.eval_points, out.evals):
        _, v = mle.evaluate(7, _t(data), n, 7, tower.from_ints(7, pt, "cpu"))
        assert tower.to_ints(7, v[None])[0] == ev


def test_wrong_product_rejected():
    claims, wits, _ = _instances()
    claims[1] = gkr_gpa.GrandProductClaim(claims[1].n_vars, claims[1].product ^ 1)
    t = ProverTranscript()
    gkr_gpa.batch_prove(claims, wits, t)
    proof = t.finalize()
    with pytest.raises(ValueError):
        jgpa.batch_verify([jgpa.GrandProductClaim(c.n_vars, c.product) for c in claims],
                          JVerifier(proof))
    with pytest.raises(ValueError):
        gkr_gpa.batch_verify(claims, VerifierTranscript(proof))


@pytest.mark.parametrize("chunk", [sc_prove.STACKED_CHUNK_ELEMS, 24])
def test_stacked_prover_equals_unstacked(chunk, monkeypatch):
    """m claims of eq * A_j * B_j at one point: one stacked prover writes
    the transcript of m `RegularSumcheckProver`s."""
    monkeypatch.setattr(sc_prove, "STACKED_CHUNK_ELEMS", chunk)
    m, n = 5, 4
    ab = _t(_values(2 * m, n, 21).reshape(2 * m, 1 << n, 4))
    point = [int(x) for x in np.random.default_rng(22).integers(0, 1 << 62, n)]
    comp = CompositionPoly(ArithExpr.var(0) * ArithExpr.var(1) * ArithExpr.var(2), 3)
    sums = []
    eq = sc_prove.eq_ind_expansion_multilinear(point, "cpu")[1]
    for j in range(m):
        prod = tower.mul(7, tower.mul(7, ab[2 * j], ab[2 * j + 1]), eq)
        sums.append(tower.to_ints(7, tower.xor_reduce(prod, 0)[None])[0])
    claims = [SumcheckClaim(n, 3, (CompositeSumClaim(comp, s),)) for s in sums]

    t1 = ProverTranscript()
    stacked = sc_prove.EqStackedSumcheckProver(
        claims, ArithExpr.var(0) * ArithExpr.var(1), torch.cat([ab, eq[None]]),
        [(2 * j, 2 * j + 1) for j in range(m)], point)
    out1 = sc_prove.batch_prove([stacked], t1)
    t2 = ProverTranscript()
    provers = [sc_prove.RegularSumcheckProver(
        claims[j], [(7, eq), (7, ab[2 * j]), (7, ab[2 * j + 1])], order_high=False,
        eq_ind_challenges=tuple(point)) for j in range(m)]
    out2 = sc_prove.batch_prove(provers, t2)
    assert t1.finalize() == t2.finalize()
    assert out1.multilinear_evals == out2.multilinear_evals
    assert out1.challenges == out2.challenges


@pytest.mark.parametrize("n_vars", [0, 1, 4])
def test_prodcheck_matches_reference(n_vars):
    vals = _values(1, n_vars, 30 + n_vars)[0]
    ours = prodcheck.ProductCircuitLayers.compute(_t(vals), n_vars)
    theirs = jprod.ProductCircuitLayers.compute(jnp.asarray(vals), n_vars)
    assert ours.product == theirs.product
    assert len(ours.layers) == len(theirs.layers)
    for a, b in zip(ours.layers, theirs.layers):
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b).view(np.uint32))
    t = ProverTranscript()
    out = prodcheck.prove(prodcheck.ProdcheckClaim(n_vars, ours.product), ours, t)
    proof = t.finalize()
    vt = JVerifier(proof)
    ver = jprod.verify(jprod.ProdcheckClaim(n_vars, ours.product), vt)
    vt.finalize()
    assert (ver.eval_point, ver.eval) == (out.eval_point, out.eval)
    _, v = mle.evaluate(7, _t(vals), n_vars, 7, tower.from_ints(7, out.eval_point, "cpu"))
    assert tower.to_ints(7, v[None])[0] == out.eval
    if n_vars:
        with pytest.raises(ValueError):
            prodcheck.verify(prodcheck.ProdcheckClaim(n_vars, ours.product ^ 1),
                             VerifierTranscript(proof))


def test_prodcheck_non_power_of_two_rejected():
    with pytest.raises(ValueError):
        prodcheck.ProductCircuitLayers.compute(_t(_values(1, 3, 1)[0][:6]), 3)


def _point(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, 1 << 63)) << 64 | int(rng.integers(0, 1 << 63))
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["StepDown", "StepUp"])
@pytest.mark.parametrize("n_vars,index", [(3, 5), (4, 16), (6, 0), (6, 37)])
def test_step_masks_match_reference(kind, n_vars, index):
    ours = getattr(transparent, kind)(n_vars, index)
    theirs = getattr(jtp, kind)(n_vars, index)
    for s in range(3):
        q = _point(n_vars, 100 * n_vars + index + s)
        assert ours.evaluate_scalar(q) == theirs.evaluate_scalar(q)
    lvl, data = ours.mle("cpu")
    jlvl, jdata = theirs.mle()
    assert lvl == jlvl == 0
    assert np.array_equal(data.numpy().view(np.uint32), np.asarray(jdata).view(np.uint32))


@pytest.mark.parametrize("which", ["bitand1", "bitand2", "incr", "incrementing"])
def test_structured_matches_reference(which):
    if which.startswith("bitand"):
        nb = int(which[-1])
        n, expr, jexpr = (2 * nb, indexed_lookup.bitand_merged_expr(nb),
                          jlookup.bitand_merged_expr(nb))
    elif which == "incr":
        n, expr, jexpr = 9, indexed_lookup.incr_merged_expr(), jlookup.incr_merged_expr()
    else:
        n, expr, jexpr = 5, transparent.incrementing_expr(5), jtp.incrementing_expr(5)
    ours = transparent.StructuredArith(expr, n, 5)
    theirs = jtp.StructuredArith(jexpr, n, 5)
    for s in range(2):
        q = _point(n, 7 * n + s)
        assert ours.evaluate_scalar(q) == theirs.evaluate_scalar(q)
    lvl, data = ours.mle("cpu")
    jlvl, jdata = theirs.mle()
    assert lvl == jlvl == 5
    assert np.array_equal(data.numpy().view(np.uint32), np.asarray(jdata).view(np.uint32))
    if which.startswith("bitand"):
        assert tower.to_ints(5, data) == [indexed_lookup.bitand_index_to_entry(i, nb)
                                          for i in range(1 << n)]
    with pytest.raises(AssertionError):
        transparent.StructuredArith(ArithExpr.var(0) * ArithExpr.var(0), 1)


def test_b128_structured_level():
    """A structured column kept at B128 (its level unreduced)."""
    ours = transparent.StructuredArith(transparent.incrementing_expr(3), 3)
    theirs = jtp.StructuredArith(jtp.incrementing_expr(3), 3)
    assert np.array_equal(ours.mle("cpu")[1].numpy().view(np.uint32),
                          np.asarray(theirs.mle()[1]).view(np.uint32))
    assert jtower.to_ints(7, theirs.mle()[1]) == list(range(8))


def test_evaluate_frees_its_temporaries(monkeypatch):
    """`ArithExpr.evaluate` keeps no reference cycle: with the cyclic
    collector off, its intermediate products die when it returns (fault
    C2: a recursive closure held every temporary of the stacked rounds
    until the collector ran, and keccak_lookups 2^13 ran out of memory on
    the card)."""
    import gc
    import weakref

    made = []
    mul = tower.mul

    def recording(level, a, b):
        out = mul(level, a, b)
        made.append(weakref.ref(out))
        return out

    monkeypatch.setattr(tower, "mul", recording)
    x = _t(_values(1, 3, 5)[0])
    expr = ArithExpr.const(1) + ArithExpr.var(0) * (ArithExpr.const(5, 7)
                                                    + ArithExpr.const(9, 7) * ArithExpr.var(1))
    gc.disable()
    try:
        out = expr.evaluate(7, [x, x])
        assert len(made) == 2
        assert [r() is None for r in made] == [True, True]
        assert out.shape == x.shape
    finally:
        gc.enable()

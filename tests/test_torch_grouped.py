"""The grouped zerocheck prover: same-structure claims proven as one
`GroupedRegularSumcheckProver` in stage 2 give the bytes of one prover per
claim, and both give the JAX package's bytes (pinned digests, computed once
with the JAX package on the CPU by `scripts/port_golden_proof.py`: its
`batch_prove` on these claims takes 24-51 s on a CPU, its `prove` minutes)."""

import hashlib
import random

import numpy as np
import pytest
import torch

from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.fields import tower
from binius_tpu_torch.m3 import instances
from binius_tpu_torch.math.arith import ArithExpr, CompositionPoly
from binius_tpu_torch.protocols.sumcheck import front_loaded
from binius_tpu_torch.protocols.sumcheck import prove as sc_prove
from binius_tpu_torch.protocols.sumcheck import univariate_zerocheck as uzc
from binius_tpu_torch.protocols.sumcheck.common import CompositeSumClaim, SumcheckClaim
from binius_tpu_torch.protocols.sumcheck.zerocheck import ZerocheckClaim
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript

torch.set_num_threads(1)
CPU = torch.device("cpu")
LEVEL = 7
V = ArithExpr.var

# (skip, transcript bytes, sha256) of the JAX package's ungrouped
# `batch_prove` on `_claims(size)`:
#   python scripts/port_golden_proof.py --circuit grouped_zerocheck --size 6 (and 8)
GOLDEN_GROUPED_ZEROCHECK = {
    6: (6, 1584, "a53fa1cbea04018f1c7f016f376c6ffbd84dd8aac2ca2b08766c6ab6a794947d"),
    8: (7, 2688, "61d988ff3678b9277f88f6a5102d79c7da496387ed44bfa2f7f924e9f4b5e608"),
}
# (bytes, sha256) of the JAX package's proof of
# `m3.instances.grouped_lookup_exp_instance(17)` (log_inv_rate 1):
#   python scripts/port_golden_proof.py --circuit grouped_lookup_exp --seed 17
GOLDEN_GROUPED_LOOKUP_EXP = (120816,
                             "e0872180579ef3a25c67755a0a59b9a17a2c0ca23115a13787cefc7d776dbeec")


def _claims(size: int):
    """The claims of `tests/test_univariate_zerocheck.py`'s grouped test at
    2^size rows: three out + a*b (out = a AND b), then one out + a*a."""
    rng = random.Random(7)
    claims, mls = [], []
    for _ in range(3):
        a = [rng.randrange(2) for _ in range(1 << size)]
        b = [rng.randrange(2) for _ in range(1 << size)]
        out = [x & y for x, y in zip(a, b)]
        claims.append(ZerocheckClaim(size, 3, (CompositionPoly(V(0) + V(1) * V(2), 3),)))
        mls.append([(0, tower.from_ints(0, v, CPU)) for v in (out, a, b)])
    a = [rng.randrange(2) for _ in range(1 << size)]
    claims.append(ZerocheckClaim(size, 2, (CompositionPoly(V(0) + V(1) * V(1), 2),)))
    mls.append([(0, tower.from_ints(0, a, CPU)), (0, tower.from_ints(0, a, CPU))])
    return claims, mls


@pytest.fixture
def grouped_spy(monkeypatch):
    """The claim counts of every grouped prover built."""
    built = []

    class Spy(sc_prove.GroupedRegularSumcheckProver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self.n_claims)

    monkeypatch.setattr(sc_prove, "GroupedRegularSumcheckProver", Spy)
    return built


@pytest.mark.parametrize("size", [6, 8])
def test_zerocheck_grouped_equals_per_claim_and_jax(size, grouped_spy):
    """Grouped and per-claim stage 2 write the same transcript, the JAX
    package's; at 2^6 rows every variable is skipped (no stage-2 round, so
    no group forms), at 2^8 the three same-structure claims are one group."""
    claims, mls = _claims(size)
    skip = uzc.compute_skip_rounds(claims)
    tapes = {}
    for group in (False, True):
        pt = ProverTranscript()
        uzc.batch_prove(claims, mls, pt, skip, group_claims=group)
        tapes[group] = pt.finalize()
    want_skip, n_bytes, sha = GOLDEN_GROUPED_ZEROCHECK[size]
    assert skip == want_skip
    assert tapes[True] == tapes[False]
    assert (len(tapes[True]), hashlib.sha256(tapes[True]).hexdigest()) == (n_bytes, sha)
    assert grouped_spy == ([] if size - skip < 1 else [3])
    vt = VerifierTranscript(tapes[True])
    uzc.batch_verify(claims, vt, skip)
    vt.finalize()


def _random_claims(n_claims: int, n_vars: int, seed: int):
    """Claims of one structure (two composites over eq and 3 multilinears)
    with random B128 multilinears, and their sums."""
    rng = np.random.default_rng(seed)
    exprs = (V(0) * V(1) * V(2) + V(3), V(0) * (V(3) + V(1)))
    stack = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n_claims, 4, 1 << n_vars, 4),
                                          dtype=np.int64).astype(np.int32))
    claims = []
    for g in range(n_claims):
        sums = []
        for e in exprs:
            vals = e.evaluate(LEVEL, [stack[g, i] for i in range(4)])
            sums.append(tower.to_ints(LEVEL, tower.xor_reduce(vals, 0)[None])[0])
        claims.append(SumcheckClaim(n_vars, 4, tuple(
            CompositeSumClaim(CompositionPoly(e, 4), s) for e, s in zip(exprs, sums))))
    return claims, stack


@pytest.mark.parametrize("order_high", [True, False])
def test_grouped_prover_equals_regular_provers(order_high):
    """One grouped prover writes the front-loaded batch's transcript of one
    `RegularSumcheckProver` per claim, beside a prover of other claims."""
    claims, stack = _random_claims(3, 5, 11)
    other, ostack = _random_claims(1, 4, 12)
    tapes = []
    for grouped in (False, True):
        if grouped:
            provers = [sc_prove.GroupedRegularSumcheckProver(claims, stack, order_high)]
        else:
            provers = [sc_prove.RegularSumcheckProver(c, [(LEVEL, stack[g, i]) for i in range(4)],
                                                      order_high)
                       for g, c in enumerate(claims)]
        provers = [sc_prove.RegularSumcheckProver(other[0], [(LEVEL, ostack[0, i])
                                                             for i in range(4)], order_high),
                   *provers]
        pt = ProverTranscript()
        fl = front_loaded.FrontLoadedBatchProver(provers, pt)
        for _ in range(5):
            fl.send_round_proof(pt)
            fl.receive_challenge(pt.sample_scalar(LEVEL))
        fl.finish(pt)
        tapes.append((pt.finalize(), fl.multilinear_evals))
    assert tapes[0] == tapes[1]


def test_fold_skipped_group_equals_per_claim():
    """The group's Lagrange fold of the skipped variables is each claim's."""
    claims, mls = _claims(8)
    lagr = tower.from_ints(LEVEL, [random.Random(3).getrandbits(128) for _ in range(1 << 5)], CPU)
    body = uzc._fold_skipped_group(mls[:3], 8, 5, lagr)
    assert body.shape == (3, 3, 1 << 3, 4)
    for g in range(3):
        assert torch.equal(body[g], uzc._fold_skipped(mls[g], 8, 5, lagr))


def test_group_claims_default_follows_device():
    """Grouping is on for CUDA and off for the CPU unless the caller names it."""
    assert uzc._group_claims(None, torch.device("cuda")) is True
    assert uzc._group_claims(None, CPU) is False
    assert uzc._group_claims(True, CPU) is True
    assert uzc._group_claims(False, torch.device("cuda")) is False


def test_prove_grouped_lookup_exp(grouped_spy):
    """`prove(group_claims=True)` on the lookups-and-exponentiation instance
    (its two u32_add tables' claims one group) has the per-claim proof's
    bytes and the JAX package's, and verifies."""
    core, witness = instances.grouped_lookup_exp_instance(17, device=CPU)
    grouped = csp.prove(core, witness, log_inv_rate=1, device=CPU, group_claims=True)
    assert any(n >= 2 for n in grouped_spy)
    grouped_spy.clear()
    per_claim = csp.prove(core, witness, log_inv_rate=1, device=CPU, group_claims=False)
    assert grouped_spy == []
    assert grouped == per_claim
    assert (len(grouped), hashlib.sha256(grouped).hexdigest()) == GOLDEN_GROUPED_LOOKUP_EXP
    csp.verify(core, grouped, log_inv_rate=1, device=CPU)

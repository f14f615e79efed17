"""The port's packed, projected and zero-padded oracles against the JAX
package's, on the CPU.

The hand-built oracle sets of the JAX package's `tests/test_evalcheck.py`
(a B32 column projected at two B128 values from variable 1, a B32 column
zero-padded by two variables at block 2 from variable 1, a B8 column
packed twice into B32), and a bit-packed B1 column packed into B32 (the
packed oracle is the column's own words), built in both packages from one
numpy seed, and one linear combination of all four kinds (with a
shifted oracle, so that a shift and a packed claim of one size share one
batched sumcheck in one wave). Compared: each virtual oracle's
materialized level and bits; the evalcheck of a claim on it, whose proof
the JAX verifier reads to the same committed claims (it reads the
sumchecks' evaluations in the order the JAX prover writes them), each
of which the witness satisfies. Rejected
in both verifiers: a packed claim with a wrong evaluation; rejected by
both walks: a non-zero claim where the zero-padded oracle's select-row
term vanishes. Exact comparisons throughout."""

import numpy as np
import pytest
import torch

from binius_tpu.constraint_system import oracle as jom
from binius_tpu.constraint_system import witness as jwitness
from binius_tpu.fields import tower as jtower
from binius_tpu.protocols import evalcheck as jevalcheck
from binius_tpu.transcript.transcript import VerifierTranscript as JVerifier
from binius_tpu_torch.constraint_system import oracle as om
from binius_tpu_torch.constraint_system import witness as cwitness
from binius_tpu_torch.convert import from_reference, to_reference
from binius_tpu_torch.fields import tower
from binius_tpu_torch.math import mle
from binius_tpu_torch.protocols import evalcheck
from binius_tpu_torch.protocols.sumcheck import prove as sc_prove
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript

torch.set_num_threads(1)  # the suite's test processes share the cores

LEVEL = 7
PROJ_VALUES = (0x0123456789ABCDEF0123456789ABCDEF, 0xFEDCBA9876543210FEDCBA9876543210)


def _projected(mod):
    s = mod.OracleSet()
    a = s.add_committed(5, 5, "a")
    return s, {a: 5}, s.add_projected(a, PROJ_VALUES, start_index=1, name="a_proj")


def _zero_padded(mod):
    s = mod.OracleSet()
    a = s.add_committed(3, 5, "a")
    return s, {a: 5}, s.add_zero_padded(a, 2, nonzero_index=2, start_index=1, name="a_pad")


def _packed(mod):
    s = mod.OracleSet()
    a = s.add_committed(6, 3, "a")
    return s, {a: 3}, s.add_packed(a, 2, "a_packed")


def _packed_bits(mod):
    s = mod.OracleSet()
    a = s.add_committed(9, 0, "bits")
    return s, {a: 0}, s.add_packed(a, 5, "bits_packed")


def _mixed(mod):
    """A linear combination over 4 variables of a packed B8 column, a
    shifted B1 column (block 2, as the packed oracle's kappa), a projected
    and a zero-padded B32 column."""
    s = mod.OracleSet()
    a = s.add_committed(6, 3, "a")
    b = s.add_committed(4, 0, "b")
    c = s.add_committed(6, 5, "c")
    d = s.add_committed(2, 5, "d")
    p = s.add_packed(a, 2, "a_packed")
    sh = s.add_shifted(b, 1, 2, "logical_left", "b_shift")
    pr = s.add_projected(c, PROJ_VALUES, start_index=1, name="c_proj")
    zp = s.add_zero_padded(d, 2, nonzero_index=1, start_index=1, name="d_pad")
    lc = s.add_linear_combination(4, [(p, 3), (sh, PROJ_VALUES[0]), (pr, 1), (zp, 7)], 5, "lc")
    return s, {a: 3, b: 0, c: 5, d: 5}, lc


CASES = {"projected": _projected, "zero_padded": _zero_padded, "packed": _packed,
         "packed_bits": _packed_bits, "mixed": _mixed}


def _rand_point(rng, n):
    return tuple(int.from_bytes(rng.bytes(16), "little") for _ in range(n))


def _value(witness, oid, n, point):
    lvl, d = tower.resolve_p1(*witness[oid])
    eq = mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, list(point), "cpu"))
    return tower.to_ints(LEVEL, mle.batched_evaluate_partial_high(lvl, d[None], n, eq, 0)[1]
                         .reshape(-1, 4))[0]


def _build(case: str, seed: int = 5, reference: bool = False):
    """Both packages' oracle set and witness of one case, its top oracle
    materialized (in the JAX package too where `reference`), and a claim
    on it at a random point."""
    rng = np.random.default_rng(seed)
    oracles, committed, top = CASES[case](om)
    joracles, _, _ = CASES[case](jom)
    witness, jwit = {}, {}
    for oid, level in committed.items():
        n = oracles[oid].n_vars
        if level == 0 and n >= tower.P1_MIN_VARS:
            words = rng.integers(0, 1 << 32, 1 << (n - 5), dtype=np.uint64).astype(np.uint32)
            witness[oid] = (tower.P1, from_reference(words, "cpu"))
            jwit[oid] = (jtower.P1, jtower.from_numpy(0, words))
            continue
        vals = rng.integers(0, 1 << (1 << level), 1 << n, dtype=np.uint64).astype(np.uint32)
        witness[oid] = (level, from_reference(vals, "cpu"))
        jwit[oid] = (level, jtower.from_numpy(level, vals))
    cwitness.materialize(oracles, witness, top)
    if reference:
        jwitness.materialize(joracles, jwit, top)
    n = oracles[top].n_vars
    point = _rand_point(rng, n)
    claim = evalcheck.EvalcheckClaim(top, point, _value(witness, top, n, point))
    return oracles, witness, joracles, jwit, claim


def _triples(claims):
    return [(c.oracle_id, c.point, c.eval) for c in claims]


@pytest.mark.parametrize("case", sorted(CASES))
def test_materialize_matches_reference(case):
    oracles, witness, _, jwit, _ = _build(case, reference=True)
    assert set(witness) == set(jwit)
    for oid, (jlvl, jdata) in jwit.items():
        lvl, data = witness[oid]
        assert lvl == jlvl, oracles[oid].name
        assert np.array_equal(to_reference(data), np.asarray(jdata)), oracles[oid].name


def test_packed_bits_are_the_words():
    """A bit-packed B1 column packed into B32 is a view of its words."""
    oracles, witness, _, _, claim = _build("packed_bits")
    bits, packed = witness[0][1], witness[claim.oracle_id][1]
    assert witness[claim.oracle_id][0] == 5
    assert packed.data_ptr() == bits.data_ptr()


@pytest.mark.parametrize("case", ["projected", "zero_padded", "packed", "packed_bits", "mixed"])
def test_evalcheck_read_by_reference_verifier(case, monkeypatch):
    """The port's proof reduces to claims on the committed oracles, each of
    which the witness satisfies, and both verifiers read it to the same
    claims. In the mixed wave the packed and the shift claim (both of 2
    variables) share one batched bivariate prover."""
    oracles, witness, joracles, _, claim = _build(case)
    made = []
    init = sc_prove.BatchedBivariateSumcheckProver.__init__

    def recording(self, claims, *a, **k):
        made.append(len(claims))
        init(self, claims, *a, **k)

    monkeypatch.setattr(sc_prove.BatchedBivariateSumcheckProver, "__init__", recording)
    pt = ProverTranscript()
    out = evalcheck.prove(oracles, witness, [claim], pt)
    proof = pt.finalize()
    assert made == {"mixed": [2], "packed": [1], "packed_bits": [1]}.get(case, [])
    assert {c.oracle_id for c in out} == set(CASES[case](om)[1])
    for c in out:
        assert _value(witness, c.oracle_id, oracles[c.oracle_id].n_vars, c.point) == c.eval
    vt = VerifierTranscript(proof)
    assert _triples(evalcheck.verify(oracles, [claim], vt)) == _triples(out)
    vt.finalize()
    jt = JVerifier(proof)
    jclaim = jevalcheck.EvalcheckClaim(claim.oracle_id, claim.point, claim.eval)
    assert _triples(jevalcheck.verify(joracles, [jclaim], jt)) == _triples(out)
    jt.finalize()


def test_packed_wrong_eval_rejected():
    oracles, witness, joracles, _, claim = _build("packed")
    bad = evalcheck.EvalcheckClaim(claim.oracle_id, claim.point, claim.eval ^ 1)
    pt = ProverTranscript()
    evalcheck.prove(oracles, witness, [bad], pt)
    proof = pt.finalize()
    with pytest.raises(ValueError):
        evalcheck.verify(oracles, [bad], VerifierTranscript(proof))
    with pytest.raises(ValueError):
        jevalcheck.verify(joracles, [jevalcheck.EvalcheckClaim(*_triples([bad])[0])],
                          JVerifier(proof))


def test_zero_padded_vanishing_term():
    """Where a padding coordinate makes the select-row term vanish, the
    evaluation must be zero: a zero claim reduces to nothing, a non-zero
    one is refused by both packages."""
    oracles, witness, joracles, _, claim = _build("zero_padded")
    # nonzero_index 2 = bits (0, 1): the term's first factor is 1 + z_1
    point = claim.point[:1] + (1,) + claim.point[2:]
    assert _value(witness, claim.oracle_id, 5, point) == 0
    ok = evalcheck.EvalcheckClaim(claim.oracle_id, point, 0)
    pt = ProverTranscript()
    assert evalcheck.prove(oracles, witness, [ok], pt) == []
    assert evalcheck.verify(oracles, [ok], VerifierTranscript(pt.finalize())) == []
    bad = evalcheck.EvalcheckClaim(claim.oracle_id, point, 1)
    with pytest.raises(ValueError, match="vanish"):
        evalcheck.verify(oracles, [bad], VerifierTranscript(b""))
    with pytest.raises(ValueError, match="vanish"):
        jevalcheck.verify(joracles, [jevalcheck.EvalcheckClaim(*_triples([bad])[0])],
                          JVerifier(b""))

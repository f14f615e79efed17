"""The ported PIOP (front-loaded bivariate sumcheck interleaved with FRI)
at the shapes of `tests/test_piop.py::setup`, on the CPU: the port's
verifier accepts the port's proof and rejects a wrong sum, and the
committed evaluations it returns equal the scalar evaluation of each
committed multilinear at the reduced point. The proof bytes against the
JAX package are held by `test_torch_opening.py`."""

import numpy as np
import pytest
import torch

from binius_tpu_torch.fields import scalar, tower
from binius_tpu_torch.protocols import fri, piop
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript

torch.set_num_threads(1)  # the suite's test processes share the cores

LEVEL = 7


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(16), "little") for _ in range(n)]


def _mle_eval(vals, point):
    cur = list(vals)
    for r in point:
        cur = [cur[2 * i] ^ scalar.mul(LEVEL, cur[2 * i] ^ cur[2 * i + 1], r)
               for i in range(len(cur) // 2)]
    return cur[0]


def _inner(a, b):
    acc = 0
    for x, y in zip(a, b):
        acc ^= scalar.mul(LEVEL, x, y)
    return acc


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    meta = piop.CommitMeta((0, 0, 0, 1, 2))   # one 3-variable, two 4-variable
    params = fri.FRIParams(log_dim=4, log_inv_rate=1, log_batch_size=2, fold_arities=(2, 2),
                           n_test_queries=3)
    assert meta.total_vars == 6 == params.n_fold_rounds
    c0, c1, c2, t0, t1 = (_rand(rng, n) for n in (8, 16, 16, 8, 16))
    packed = [(tower.from_ints(LEVEL, c0), 3), (tower.from_ints(LEVEL, c1), 4),
              (tower.from_ints(LEVEL, c2), 4)]
    transparents = [(tower.from_ints(LEVEL, t0), 3), (tower.from_ints(LEVEL, t1), 4)]
    transparents_v = [(3, lambda pt: _mle_eval(t0, pt)), (4, lambda pt: _mle_eval(t1, pt))]
    claims = [piop.PIOPSumcheckClaim(3, 0, 0, _inner(c0, t0)),
              piop.PIOPSumcheckClaim(4, 1, 1, _inner(c1, t1)),
              piop.PIOPSumcheckClaim(4, 2, 1, _inner(c2, t1))]
    return meta, params, packed, transparents, transparents_v, claims, (c0, c1, c2)


def _prove(meta, params, packed, transparents, claims):
    pt = ProverTranscript()
    cw, tree, _ = piop.commit(params, meta, packed, device="cpu")
    pt.message().write_bytes(tree.root)
    piop.prove(params, meta, cw, tree, packed, transparents, claims, pt, device="cpu")
    return pt.finalize()


def _verify(meta, params, proof, transparents_v, claims):
    vt = VerifierTranscript(proof)
    com = vt.message().read_bytes(32)
    out = piop.verify(params, meta, com, transparents_v, claims, vt)
    vt.finalize()
    return out


def test_piop_roundtrip_and_committed_evals(setup):
    meta, params, packed, transparents, transparents_v, claims, cols = setup
    out = _verify(meta, params, _prove(meta, params, packed, transparents, claims),
                  transparents_v, claims)
    rev = list(reversed(out.challenges))
    assert out.committed_evals == [_mle_eval(cols[0], rev[3:]), _mle_eval(cols[1], rev[2:]),
                                   _mle_eval(cols[2], rev[2:])]


def test_piop_wrong_sum_rejected(setup):
    meta, params, packed, transparents, transparents_v, claims, _ = setup
    bad = [claims[0], piop.PIOPSumcheckClaim(4, 1, 1, claims[1].sum ^ 1), claims[2]]
    proof = _prove(meta, params, packed, transparents, bad)
    with pytest.raises(ValueError):
        _verify(meta, params, proof, transparents_v, bad)


def test_evaluate_piecewise_multilinear():
    rng = np.random.default_rng(4)
    f0, f1, f2, point = _rand(rng, 4), _rand(rng, 4), _rand(rng, 2), _rand(rng, 4)
    want = _mle_eval(f0 + f1 + f2 + [0] * 6, point)
    got = piop.evaluate_piecewise_multilinear(
        point, [0, 1, 2], [_mle_eval(f0, point[:2]), _mle_eval(f1, point[:2]),
                           _mle_eval(f2, point[:1])])
    assert got == want


@pytest.mark.parametrize("level", [0, 5])
def test_ring_switch_eq_ind_mle_matches_host_eval(level):
    """The prover's transparent (device, byte-table linear map) against the
    verifier's tensor-algebra evaluation (host), at vertices and at a random
    point; the verifier's batched device evaluation agrees too."""
    from binius_tpu_torch.protocols import ring_switch

    rng = np.random.default_rng(level)
    suffix, query = _rand(rng, 3), _rand(rng, 3)
    mix, row_coeffs = _rand(rng, 1)[0], _rand(rng, 1 << (7 - level))
    data, n = ring_switch.ring_switch_eq_ind_mle(level, suffix, mix, row_coeffs, device="cpu")
    vals = tower.to_ints(LEVEL, data)
    for j in (0, 3, 7):
        vertex = [(j >> i) & 1 for i in range(n)]
        assert vals[j] == ring_switch.ring_switch_eq_ind_eval(level, suffix, mix, row_coeffs,
                                                              vertex)
    want = ring_switch.ring_switch_eq_ind_eval(level, suffix, mix, row_coeffs, query)
    assert _mle_eval(vals, query) == want
    assert ring_switch.ring_switch_eq_ind_eval_batch(
        level, [suffix, suffix], [mix, 1], row_coeffs, query, device="cpu")[0] == want
    e = ring_switch.TensorAlgElem(level, row_coeffs)
    assert e.transpose().transpose().elems == e.elems

"""The port's folds, zero padding, MLE helpers and univariate host algebra
against the JAX package's, at small sizes, and the M3 test helper
`validate_system_witness` on u32_add 2^3. Every comparison is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_tpu.math import fold as jfold
from binius_tpu.math import mle as jmle
from binius_tpu.math import univariate as juni
from binius_tpu_torch.math import fold, mle, univariate as uni
from binius_tpu_torch.m3.builder import test_utils

torch.set_num_threads(1)  # the suite's test processes share the cores


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def _same(port, ref) -> bool:
    level, data = port
    rlevel, rdata = ref
    return level == rlevel and np.array_equal(data.numpy().view(np.uint32), np.asarray(rdata))


def test_folds_match_reference():
    """Against the JAX package at B16 (B8 data promoted) and, for the
    partial evaluation, at B128; at B128 the port's folds of one variable
    also equal `fold_middle` with that variable's eq expansion."""
    rng = np.random.default_rng(1)
    d8 = _words(rng, (16,)) & 0xFF
    d16 = _words(rng, (16,)) & 0xFFFF
    r16 = _words(rng, ()) & 0xFFFF
    e16 = _words(rng, (4,)) & 0xFFFF
    assert _same(fold.fold_low(3, _t(d8), 4, 4, _t(r16)),
                 jfold.fold_low(3, jnp.asarray(d8), 4, 4, jnp.asarray(r16)))
    assert _same(fold.fold_high(4, _t(d16), 4, 4, _t(r16)),
                 jfold.fold_high(4, jnp.asarray(d16), 4, 4, jnp.asarray(r16)))
    assert _same(fold.fold_middle(4, _t(d16), 4, 4, _t(e16), 2, 1),
                 jfold.fold_middle(4, jnp.asarray(d16), 4, 4, jnp.asarray(e16), 2, 1))
    d7 = _words(rng, (16, 4))
    r = _words(rng, (4,))
    e = _words(rng, (4, 4))
    assert _same(mle.evaluate_partial_high(7, _t(d7), 4, 7, _t(e), 2),
                 jmle.evaluate_partial_high(7, jnp.asarray(d7), 4, 7, jnp.asarray(e), 2))
    one = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    e1 = torch.stack([_t(r) ^ one, _t(r)])     # eq expansion of the point (r)
    assert torch.equal(fold.fold_low(7, _t(d7), 4, 7, _t(r))[1],
                       fold.fold_middle(7, _t(d7), 4, 7, e1, 1, 0)[1])
    assert torch.equal(fold.fold_high(7, _t(d7), 4, 7, _t(r))[1],
                       fold.fold_middle(7, _t(d7), 4, 7, e1, 1, 3)[1])


@pytest.mark.parametrize("level,shape", [(3, (8,)), (7, (8, 4))])
def test_zero_pad_and_evals_01(level, shape):
    rng = np.random.default_rng(level)
    d = _words(rng, shape) & (0xFF if level == 3 else 0xFFFFFFFF)
    for front in (True, False):
        got = fold.zero_pad(level, _t(d), 3, 2, 1, front)
        want = jfold.zero_pad(level, jnp.asarray(d), 3, 2, 1, front)
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    for high in (True, False):
        for a, b in zip(fold.evals_01(level, _t(d), 3, high),
                        jfold.evals_01(level, jnp.asarray(d), 3, high)):
            assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b))


def test_mle_dataclass():
    rng = np.random.default_rng(3)
    d = _words(rng, (8, 4))
    m = mle.MLE(_t(d), 7, 3)
    jm = jmle.MLE(jnp.asarray(d), 7, 3)
    assert (m.level, m.n_vars) == (jm.level, jm.n_vars)
    with pytest.raises(AssertionError):
        mle.MLE(_t(d), 7, 4)
    with pytest.raises(AssertionError):
        jmle.MLE(jnp.asarray(d), 7, 4)


@pytest.mark.parametrize("size,level", [(3, 7), (5, 7), (9, 5)])
def test_univariate_host_algebra(size, level):
    rng = random.Random(size)
    dom = uni.EvaluationDomain.from_subspace(3, size)
    jdom = juni.EvaluationDomain.from_subspace(3, size)
    assert dom.points == jdom.points
    vals = [rng.getrandbits(1 << level) for _ in range(size)]
    z = rng.getrandbits(1 << level)
    assert dom.lagrange_evals(level, z) == jdom.lagrange_evals(level, z)
    assert dom.extrapolate(level, vals, z) == jdom.extrapolate(level, vals, z)
    # on a domain point the extrapolation is the value there
    assert dom.extrapolate(level, vals, dom.points[1]) == vals[1]
    coeffs = dom.interpolate(level, vals)
    assert uni.evaluate_univariate(level, coeffs, z) == juni.evaluate_univariate(level, coeffs, z)
    assert uni.evaluate_univariate(level, coeffs, z) == dom.extrapolate(level, vals, z)
    x0, x1 = vals[0], vals[1]
    assert uni.extrapolate_line_scalar(level, x0, x1, z) == \
        juni.extrapolate_line_scalar(level, x0, x1, z)


def test_validate_system_witness(monkeypatch):
    """The check passes on u32_add 2^3 and raises on a flipped witness bit;
    BINIUS_M3_TEST_PROVE_VERIFY=1 adds a prove and a verify of the system
    on the device named."""
    from binius_tpu_torch.m3.gadgets import arith

    rng = random.Random(4)
    xs = [rng.getrandbits(32) for _ in range(8)]
    ys = [rng.getrandbits(32) for _ in range(8)]
    core, witness = arith.u32_add_system(3, xs, ys, "cpu")
    monkeypatch.delenv("BINIUS_M3_TEST_PROVE_VERIFY", raising=False)
    test_utils.validate_system_witness(core, witness)
    oid = core.oracles.committed_ids()[0]
    level, data = witness[oid]
    bad = dict(witness)
    bad[oid] = (level, data ^ 1)
    with pytest.raises(ValueError):
        test_utils.validate_system_witness(core, bad)
    calls = []
    monkeypatch.setattr(test_utils.csp, "prove", lambda *a, **k: calls.append(("prove", k))
                        or b"proof")
    monkeypatch.setattr(test_utils.csp, "verify", lambda *a, **k: calls.append(("verify", k)))
    monkeypatch.setenv("BINIUS_M3_TEST_PROVE_VERIFY", "1")
    test_utils.validate_system_witness(core, witness, device="cpu")
    assert calls == [("prove", {"device": "cpu"}), ("verify", {"device": "cpu"})]

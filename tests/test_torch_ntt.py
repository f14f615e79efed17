"""binius_tpu_torch bitsliced additive NTT (plain versions of K3 and K4)
against the JAX package: the domain tables and the per-word twiddle plan
(the contract between the kernels and their plain version), and the
transform in the `rs_encode` configuration (B128 data, B32 twiddles,
log_x 4, skip_rounds 1) against `AdditiveNTT.forward_scalar` /
`inverse_scalar` column by column. Bit-exact."""

import functools

import numpy as np
import pytest
import torch

from binius_tpu.ntt import additive_ntt as jntt
from binius_tpu.ntt import bitsliced_ntt as jbn
from binius_tpu_torch.convert import from_reference, to_reference
from binius_tpu_torch.fields import tower
from binius_tpu_torch.ntt import additive_ntt, bitsliced_ntt


def _b128(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 4), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _domain_19():
    """The FRI domain of the 2^22-row commit (log_code_len 19)."""
    return additive_ntt.NTTDomain.create(5, 19)


def _columns(arr, log_x):
    """(2^(log_x+log_y), 4) uint32 -> per-column lists of ints (X fastest)."""
    ints = tower.to_ints(7, from_reference(arr, "cpu"))
    return [ints[x::1 << log_x] for x in range(1 << log_x)]


@pytest.mark.parametrize("level,log_dim", [(5, 6), (5, 12), (7, 4)])
def test_domain_matches_reference(level, log_dim):
    ours = additive_ntt.NTTDomain.create(level, log_dim)
    ref = jntt.NTTDomain.create(level, log_dim)
    assert ours.s_evals == ref.s_evals and ours.norm_consts == ref.norm_consts


@pytest.mark.parametrize("shape,skip,inverse", [
    ((4, 7, 0), 1, False),     # rs_encode: one intra-word stage, word pairs
    ((4, 12, 0), 1, False),    # word distances up to 2^10: K3 tile split
    ((0, 8, 1), 0, True),
    ((2, 5, 0), 0, False),
])
def test_plan_matches_reference(shape, skip, inverse):
    dom = additive_ntt.NTTDomain.create(5, shape[1] + 1)
    plan, tw = bitsliced_ntt._make_plan(dom, 7, shape, 0, 0, skip, inverse)
    rplan, rtw = jbn._make_plan(jntt.NTTDomain.create(5, shape[1] + 1), 7, shape, 0, 0,
                                skip, inverse)
    assert np.array_equal(tw, rtw)
    assert [(s.d_elems, s.deltas) for s in plan.stages] == [
        (s.d_elems, s.deltas) for s in rplan.stages]
    assert plan.tile == min(bitsliced_ntt._TILE_WORDS, plan.n_words)
    local = plan.stages[:plan.n_local] if inverse else plan.stages[len(plan.stages) - plan.n_local:]
    assert all((s.d_elems >> 5) <= plan.tile // 2 for s in local)


@pytest.mark.parametrize("shape,skip,inverse,runs", [
    ((4, 19, 0), 1, False, [(0, 7)]),          # the 2^22-row commit: one K4 launch
    ((4, 16, 0), 0, True, [(11, 5)]),
    ((4, 19, 0), 0, False, [(0, 7), (7, 1)]),  # longer than one pass
])
def test_cross_runs_cover_each_stage_once_in_order(shape, skip, inverse, runs):
    dom = _domain_19()
    plan, _ = bitsliced_ntt._make_plan(dom, 7, shape, 0, 0, skip, inverse)
    assert bitsliced_ntt._cross_runs(plan) == runs
    n = len(plan.stages)
    local = list(range(plan.n_local)) if inverse else list(range(n - plan.n_local, n))
    cross = [si for f, k in runs for si in range(f, f + k)]
    assert (local + cross if inverse else cross + local) == list(range(n))
    for f, k in runs:
        lo_bit = bitsliced_ntt._cross_lo_bit(plan, f, k)
        assert (plan.stages[f].d_elems >> 5) == 1 << (lo_bit + (0 if inverse else k - 1))
        assert plan.n_words % (1 << (lo_bit + k)) == 0
    with pytest.raises(ValueError):  # the run's order is the kernel's
        bitsliced_ntt._cross_lo_bit(plan, runs[0][0], runs[0][1] + 1)


@pytest.mark.parametrize("log_y", [4, 6])
def test_forward_rs_encode_config_matches_scalar(log_y):
    log_x, skip = 4, 1
    data = _b128(1 << (log_x + log_y), seed=log_y)
    ntt = additive_ntt.AdditiveNTT(additive_ntt.NTTDomain.create(5, log_y))
    got = ntt.forward(from_reference(data, "cpu"), 7, (log_x, log_y, 0),
                      skip_rounds=skip, device="cpu")
    ref = jntt.AdditiveNTT(jntt.NTTDomain.create(5, log_y))
    want = [ref.forward_scalar(col, 7, log_y, skip_rounds=skip) for col in _columns(data, log_x)]
    assert _columns(to_reference(got), log_x) == want


def test_inverse_matches_scalar():
    log_x, log_y = 2, 5
    data = _b128(1 << (log_x + log_y), seed=11)
    ntt = additive_ntt.AdditiveNTT(additive_ntt.NTTDomain.create(5, log_y + 1))
    got = ntt.inverse(from_reference(data, "cpu"), 7, (log_x, log_y, 0), coset=1,
                      coset_bits=1, device="cpu")
    ref = jntt.AdditiveNTT(jntt.NTTDomain.create(5, log_y + 1))
    want = [ref.inverse_scalar(col, 7, log_y, coset=1, coset_bits=1)
            for col in _columns(data, log_x)]
    assert _columns(to_reference(got), log_x) == want


def test_forward_then_inverse_is_identity():
    data = _b128(1 << 9, seed=3)
    ntt = additive_ntt.AdditiveNTT(additive_ntt.NTTDomain.create(5, 9))
    x = from_reference(data, "cpu")
    y = ntt.forward(x, 7, (0, 9, 0), device="cpu")
    assert np.array_equal(to_reference(ntt.inverse(y, 7, (0, 9, 0), device="cpu")), data)


def test_transform_planes_matches_packed_transform():
    from binius_tpu_torch.fields import bitslice

    data = from_reference(_b128(1 << 10, seed=4), "cpu")
    dom = additive_ntt.NTTDomain.create(5, 7)
    shape = (3, 7, 0)
    planes = bitslice.to_bitsliced(7, data)
    out = bitsliced_ntt.transform_planes(dom, planes, 7, shape, skip_rounds=1)
    assert torch.equal(bitslice.from_bitsliced(7, out),
                       bitsliced_ntt.transform(dom, data, 7, shape, skip_rounds=1))
    assert torch.equal(planes, bitslice.to_bitsliced(7, data))  # input untouched


def test_oracles_match_reference():
    dom = additive_ntt.NTTDomain.create(5, 5)
    rdom = jntt.NTTDomain.create(5, 5)
    vals = [int(v) for v in _b128(32, seed=8)[:, 0]]
    ours, ref = additive_ntt.AdditiveNTT(dom), jntt.AdditiveNTT(rdom)
    assert ours.forward_scalar(vals, 5, 5, skip_rounds=1) == ref.forward_scalar(vals, 5, 5, skip_rounds=1)
    assert ours.inverse_scalar(vals, 5, 5) == ref.inverse_scalar(vals, 5, 5)


def test_unported_shapes_raise():
    """The shape that raised before the packed stage loop was ported (B128
    twiddles) now transforms, through the stage loop, to the scalar
    oracle's values; no shape the bitsliced gate admits is below K3's tile."""
    ntt = additive_ntt.AdditiveNTT(additive_ntt.NTTDomain.create(7, 5))
    data = _b128(32, seed=1)
    got = ntt.forward(from_reference(data, "cpu"), 7, (0, 5, 0), device="cpu")
    ref = jntt.AdditiveNTT(jntt.NTTDomain.create(7, 5))
    assert tower.to_ints(7, got) == ref.forward_scalar(_columns(data, 0)[0], 7, 5)
    assert not bitsliced_ntt.supported(7, 7, 1 << 15)
    for n in (32, 64, 1 << 14):
        assert not bitsliced_ntt.supported(5, 7, n)


def _rand_level(level, n, seed):
    if level == 7:
        return _b128(n, seed)
    return np.random.default_rng(seed).integers(0, 1 << (1 << level), n, dtype=np.uint64
                                                ).astype(np.uint32)


@pytest.mark.parametrize("tl,dl", [(3, 3), (5, 5), (7, 7), (3, 7), (5, 7)])
@pytest.mark.parametrize("log_n", [4, 5, 6])
@pytest.mark.parametrize("inverse", [False, True])
def test_stage_loop_matches_reference(tl, dl, log_n, inverse):
    """The packed stage loop at B8, B32 and B128 twiddles on data at or
    above them, n = 16, 32, 64 (one column, a coset of a larger domain),
    against the JAX package's scalar transforms."""
    data = _rand_level(dl, 1 << log_n, seed=log_n + 10 * tl + dl)
    ntt = additive_ntt.AdditiveNTT(additive_ntt.NTTDomain.create(tl, log_n + 1))
    ref = jntt.AdditiveNTT(jntt.NTTDomain.create(tl, log_n + 1))
    x = tower.from_numpy(dl, data, "cpu")
    fn = ntt.inverse if inverse else ntt.forward
    got = fn(x, dl, (0, log_n, 0), coset=1, coset_bits=1, device="cpu")
    rfn = ref.inverse_scalar if inverse else ref.forward_scalar
    assert tower.to_ints(dl, got) == rfn(tower.to_ints(dl, x), dl, log_n, coset=1, coset_bits=1)


def test_stage_loop_zerocheck_shape_matches_reference():
    """The univariate-skip zerocheck's transform: B8 data on B8 twiddles,
    k = 7 stages over 5 rows x 2 suffixes (a batch that is not a power of
    two), inverse on coset 0 then forward on coset 1 of a 2^8 domain,
    against the JAX package's stage loop (`_transform_jit`)."""
    import jax.numpy as jnp

    data = _rand_level(3, 10 << 7, seed=4)
    ntt = additive_ntt.AdditiveNTT(additive_ntt.NTTDomain.create(3, 8))
    x = tower.from_numpy(3, data, "cpu").reshape(5, 2 << 7)
    coeffs = ntt.inverse(x, 3, (0, 7, 0), 0, 1, device="cpu")
    got = ntt.forward(coeffs, 3, (0, 7, 0), 1, 1, device="cpu")
    ref = jntt.AdditiveNTT(jntt.NTTDomain.create(3, 8))
    want = []
    for row in data.reshape(5, 2 << 7):
        rc = ref.inverse(jnp.asarray(row), 3, (0, 7, 1), 0, 1, bitsliced=False)
        want.append(np.asarray(ref.forward(rc, 3, (0, 7, 1), 1, 1, bitsliced=False)))
    assert np.array_equal(to_reference(got), np.stack(want))


@pytest.mark.parametrize("log_x,log_y,skip", [(4, 4, 1), (4, 6, 1), (2, 5, 0)])
def test_bitsliced_transform_matches_scalar(log_x, log_y, skip):
    """The bitsliced path's plain version, called directly at shapes the
    gate now sends to the stage loop."""
    data = _b128(1 << (log_x + log_y), seed=log_y + skip)
    dom = additive_ntt.NTTDomain.create(5, log_y)
    got = bitsliced_ntt.transform(dom, from_reference(data, "cpu"), 7, (log_x, log_y, 0),
                                  skip_rounds=skip)
    ref = jntt.AdditiveNTT(jntt.NTTDomain.create(5, log_y))
    want = [ref.forward_scalar(col, 7, log_y, skip_rounds=skip) for col in _columns(data, log_x)]
    assert _columns(to_reference(got), log_x) == want

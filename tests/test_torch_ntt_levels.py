"""binius_tpu_torch's bitsliced NTT at twiddle levels below B32 (the plain
version of K3 and K4 at every (dl, tl) the Pallas kernels take, fault C5):
against the port's packed stage loop, against the JAX package's scalar
transforms (`forward_scalar` / `inverse_scalar`, plain Python, column by
column) at every twiddle level B1 to B16, and at one of the JAX package's
own `CASES` shapes against its bitsliced transform (`use_pallas=False`).
Also the kernels' admission rule and the dispatch gate's truth table.
Bit-exact."""

import dataclasses

import numpy as np
import pytest
import torch

from binius_tpu_torch import cuda_lib
from binius_tpu_torch.convert import from_reference, to_reference
from binius_tpu_torch.fields import tower
from binius_tpu_torch.ntt import additive_ntt, bitsliced_ntt

torch.set_num_threads(1)  # the suite's test processes share the cores

# (dl, tl, (log_x, log_y, log_z)): 2^10 to 2^12 elements, every kind of
# stage (intra-word, word pairs) at B8 and B16 twiddles on B8 to B128 data
LEVELS = [
    (3, 3, (2, 7, 1)),
    (4, 3, (3, 7, 0)),
    (5, 3, (5, 7, 0)),
    (5, 4, (0, 11, 0)),
    (7, 3, (4, 7, 0)),
]


# (dl, tl, shape, coset_bits, skip_rounds) held against the JAX package's
# scalar transforms on coset 1 (0 where no coset bit): LEVELS, and B1, B2
# and B4 twiddles on B32 data (chip_smoke's LEVEL_SHAPES cut to 2^10-2^11
# elements), B4's first with blocks below a word on a coset
SCALAR_CASES = [(dl, tl, shape, 1, 1) for dl, tl, shape in LEVELS] + [
    (5, 0, (4, 1, 6), 0, 0),
    (5, 1, (8, 2, 0), 0, 0),
    (5, 2, (0, 3, 8), 1, 1),
    (5, 2, (7, 4, 0), 0, 1),
]


def _data(dl, n, seed):
    rng = np.random.default_rng(seed)
    if tower.has_limb_dim(dl):
        return rng.integers(0, 1 << 32, size=(n, tower.n_limbs(dl)), dtype=np.uint32)
    return rng.integers(0, 1 << (1 << dl), size=n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dl,tl,shape", LEVELS)
def test_bitsliced_levels_match_stage_loop(dl, tl, shape, inverse):
    """Forward and inverse on coset 1 of a domain one bit larger, with one
    round skipped: the bitsliced plain path equals the stage loop."""
    n = 1 << sum(shape)
    x = tower.from_numpy(dl, _data(dl, n, seed=10 * dl + tl), "cpu")
    dom = additive_ntt.NTTDomain.create(tl, shape[1] + 1)
    kw = dict(coset=1, coset_bits=1, skip_rounds=1, inverse=inverse)
    got = bitsliced_ntt.transform(dom, x, dl, shape, **kw)
    want = additive_ntt.AdditiveNTT(dom)._stage_loop(x, dl, shape, 1, 1, 1, inverse)
    assert torch.equal(got, want)


def _reference_scalar(dl, tl, shape, ints, coset, coset_bits, skip, inverse):
    """The JAX package's scalar transform of each column (each x of each z
    block) of the flat batch `ints`, as a flat list."""
    from binius_tpu.ntt import additive_ntt as jntt

    log_x, log_y, log_z = shape
    ref = jntt.AdditiveNTT(jntt.NTTDomain.create(tl, log_y + coset_bits))
    fn = ref.inverse_scalar if inverse else ref.forward_scalar
    cols = np.array(ints, dtype=object).reshape(1 << log_z, 1 << log_y, 1 << log_x)
    out = np.empty_like(cols)
    for z in range(1 << log_z):
        for x in range(1 << log_x):
            out[z, :, x] = fn(list(cols[z, :, x]), dl, log_y, coset, coset_bits, skip)
    return out.ravel().tolist()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dl,tl,shape,coset_bits,skip", SCALAR_CASES)
def test_levels_match_reference_scalar(dl, tl, shape, coset_bits, skip, inverse):
    """The bitsliced plain path (the plain version the card's K3 and K4
    are held to) equals the JAX package's scalar transforms, column by
    column, at B1 to B16 twiddles."""
    n = 1 << sum(shape)
    x = tower.from_numpy(dl, _data(dl, n, seed=100 * dl + 10 * tl + skip), "cpu")
    dom = additive_ntt.NTTDomain.create(tl, shape[1] + coset_bits)
    coset = 1 if coset_bits else 0
    got = bitsliced_ntt.transform(dom, x, dl, shape, coset, coset_bits, skip_rounds=skip,
                                  inverse=inverse)
    assert tower.to_ints(dl, got) == _reference_scalar(dl, tl, shape, tower.to_ints(dl, x),
                                                       coset, coset_bits, skip, inverse)


def test_matches_reference_case():
    """The JAX package's `CASES` shape (3, 3, 4, 7): B8 data on B8
    twiddles, word and intra-word stages, forward and inverse."""
    from binius_tpu.fields import tower as jtower
    from binius_tpu.ntt import additive_ntt as jntt
    from binius_tpu.ntt import bitsliced_ntt as jbn

    shape = (4, 7, 0)
    data = _data(3, 1 << 11, seed=307)
    dom = additive_ntt.NTTDomain.create(3, 7)
    jdom = jntt.NTTDomain.create(3, 7)
    for inverse in (False, True):
        got = bitsliced_ntt.transform(dom, from_reference(data, "cpu"), 3, shape,
                                      inverse=inverse)
        want = jbn.transform(jdom, jtower.from_numpy(3, data), 3, shape, inverse=inverse,
                             use_pallas=False)
        assert np.array_equal(to_reference(got), np.asarray(want))


def test_fault_c5_call():
    """The call that raised on CUDA (fault C5): a B8-domain transform of
    2^15 B32 elements takes the bitsliced path and equals the stage loop."""
    ntt = additive_ntt.AdditiveNTT(additive_ntt.NTTDomain.create(3, 8))
    x = tower.from_numpy(5, _data(5, 1 << 15, seed=5), "cpu")
    assert bitsliced_ntt.supported(3, 5, 1 << 15)
    got = ntt.forward(x, 5, (7, 8, 0), device="cpu")
    assert torch.equal(got, ntt._stage_loop(x, 5, (7, 8, 0), 0, 0, 0, False))


@pytest.mark.parametrize("shape,coset_bits,coset", [((0, 3, 7), 2, 1), ((1, 2, 7), 1, 1)])
def test_block_below_a_word_matches_stage_loop(shape, coset_bits, coset):
    """Fault C6: where a block is smaller than a word (log_x + log_y < 5)
    on a coset of a larger domain, an intra-word stage's twiddle depends
    on the block bits alone, not on the z bits beside them in the word:
    equal to the stage loop and to the JAX package's scalar transforms
    (which its bitsliced transform departs from there)."""
    dom = additive_ntt.NTTDomain.create(3, shape[1] + coset_bits)
    x = tower.from_numpy(3, _data(3, 1 << sum(shape), seed=6), "cpu")
    for inverse in (False, True):
        got = bitsliced_ntt.transform(dom, x, 3, shape, coset, coset_bits, inverse=inverse)
        want = additive_ntt.AdditiveNTT(dom)._stage_loop(x, 3, shape, coset, coset_bits, 0,
                                                        inverse)
        assert torch.equal(got, want)
        assert tower.to_ints(3, got) == _reference_scalar(
            3, 3, shape, tower.to_ints(3, x), coset, coset_bits, 0, inverse)


def test_split_plan_matches_stage_loop(monkeypatch):
    """With K3's tile cut to 8 words, a B8-twiddle plan on B16 data has
    cross runs (K4's stages at word distances of 8 and up) and local
    stages (K3's, intra-word among them); the wrappers' split equals the
    stage loop both ways, and each cross run is one K4 launch's shape."""
    monkeypatch.setattr(bitsliced_ntt, "_TILE_WORDS", 8)
    monkeypatch.setattr(bitsliced_ntt, "_PLAN_CACHE", {})
    monkeypatch.setattr(bitsliced_ntt, "_DEV_CACHE", {})
    dom = additive_ntt.NTTDomain.create(3, 8)
    shape = (4, 8, 0)
    x = tower.from_numpy(4, _data(4, 1 << 12, seed=41), "cpu")
    for inverse in (False, True):
        plan, _ = bitsliced_ntt._make_plan(dom, 4, shape, 0, 0, 0, inverse)
        runs = bitsliced_ntt._cross_runs(plan)
        assert plan.n_local and runs
        for f, k in runs:
            assert bitsliced_ntt._cross_lo_bit(plan, f, k) >= 3
        got = bitsliced_ntt.transform(dom, x, 4, shape, inverse=inverse)
        want = additive_ntt.AdditiveNTT(dom)._stage_loop(x, 4, shape, 0, 0, 0, inverse)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dl,tl,shape", LEVELS + [(7, 5, (4, 12, 0)), (5, 0, (14, 1, 0))])
def test_cuda_admission(dl, tl, shape, monkeypatch):
    """`_check_cuda_plan` takes every plan `_make_plan` makes (the tensor
    checks, which need a CUDA tensor, stubbed), launches 2^(dl - tl)
    groups, and refuses a twiddle level above B32 or planes of another
    shape."""
    monkeypatch.setattr(cuda_lib, "check", lambda *a, **k: None)
    dom = additive_ntt.NTTDomain.create(tl, shape[1])
    for inverse in (False, True):
        plan, _ = bitsliced_ntt._make_plan(dom, dl, shape, 0, 0, 0, inverse)
        planes = torch.zeros((1 << dl, plan.n_words), dtype=torch.int32)
        bitsliced_ntt._check_cuda_plan(plan, planes, "test")
        assert bitsliced_ntt._groups(plan) == 1 << (dl - tl)
        meta = bitsliced_ntt._local_meta_np(plan, 0 if inverse else
                                            len(plan.stages) - plan.n_local)
        assert meta.shape == (plan.n_local, 33)
        with pytest.raises(ValueError):
            bitsliced_ntt._check_cuda_plan(dataclasses.replace(plan, tl=6), planes, "test")
        with pytest.raises(ValueError):
            bitsliced_ntt._check_cuda_plan(plan, planes[:, :-4], "test")


def test_supported_truth_table():
    """The gate keeps its rule, the JAX package's `wants_dispatch`: twiddles
    at B32 or below, data at B32 or above and at or above the twiddles, a
    power-of-two batch of at least 2^15 elements."""
    admitted = {(tl, dl) for tl in range(8) for dl in range(8)
                if bitsliced_ntt.supported(tl, dl, 1 << 15)}
    assert admitted == {(tl, dl) for tl in range(6) for dl in range(5, 8)}
    for n in (1 << 14, (1 << 15) + 32, 3 << 15):
        assert not any(bitsliced_ntt.supported(tl, dl, n) for tl, dl in admitted)
    assert all(bitsliced_ntt.supported(tl, dl, 1 << 22) for tl, dl in admitted)

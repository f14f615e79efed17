"""Stage 1 of the port's univariate-skip zerocheck takes the NTT route the
JAX package's takes (fault C7). `_uni_chunk_jit` pads a chunk's rows to a
power of two m_pad and transforms them as one flat batch of
m_pad * chunk * 2^k elements, shape (0, k, log2(m_pad * chunk)), which
`bitsliced_ntt.wants_dispatch` sends to the bitsliced transform on its
device when the data is at B32 or above and the batch holds at least 2^15
elements; the port's `_claim_round_evals` builds the same batch and its
`AdditiveNTT` sends it to `bitsliced_ntt.transform` (K2, K3 and K4 on the
card; their plain versions here) by the same rule.

(a) At B32 data (4 and 3 B32 multilinears) and B128 data (B1 and B64
    columns, as in div_uu32) with 13 variables, 7 skipped, the flat batch
    reaches 2^15 elements: the port's round evaluations equal the JAX
    package's `univariate_zerocheck._claim_round_evals` on the CPU (where
    `wants_dispatch` is false and it runs its stage loop) and the port's own
    stage loop (the bitsliced gate closed by a spy), byte for byte.
(b) A spy on `bitsliced_ntt.transform` sees the route taken exactly where
    the JAX package's `wants_dispatch` (its backend and device count set to
    one TPU) admits the batch: not at B8 data (a u32_add-shaped claim), not
    at B16, not under 2^15 elements.
(c) b32_mul 2^10 and div_uu32 2^2, with the gate lowered so that their
    stage 1 takes the bitsliced route, keep their pinned digests
    (`chip_smoke.GOLDEN_CIRCUITS`).

The JAX calls: `univariate_zerocheck._claim_round_evals` and
`bitsliced_ntt.wants_dispatch`; the JAX `prove` is not run."""

import hashlib
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from binius_tpu.math import arith as jarith
from binius_tpu.ntt import bitsliced_ntt as jbn
from binius_tpu.protocols.sumcheck import univariate_zerocheck as juzc
from binius_tpu.protocols.sumcheck import zerocheck as jzc
from binius_tpu_torch import circuits
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.fields import tower
from binius_tpu_torch.math import arith
from binius_tpu_torch.ntt import bitsliced_ntt
from binius_tpu_torch.protocols.sumcheck import univariate_zerocheck as uzc
from binius_tpu_torch.protocols.sumcheck import zerocheck

torch.set_num_threads(1)  # the suite's test processes share the cores

# (multilinear levels, their compositions as (a, b, c): V(a) * V(b) + V(c))
# of each claim shape; P1 is a bit-packed B1 column
CLAIMS = {
    "b32x4": ((5, 5, 5, 5), ((0, 1, 2), (2, 3, 0))),
    "b32x3": ((5, 5, 5), ((0, 1, 2),)),
    "b1_b64": ((tower.P1, 0, 6), ((0, 2, 1), (1, 0, 2))),
    "b16x4": ((4, 4, 4, 4), ((0, 1, 2), (3, 2, 1))),
    "u32_add": ((tower.P1,) * 5, ((0, 1, 2), (3, 4, 0))),
}


def _claim(arith_mod, zc_mod, n, name):
    levels, comps = CLAIMS[name]
    V = arith_mod.ArithExpr.var
    return zc_mod.ZerocheckClaim(n, len(levels), tuple(
        arith_mod.CompositionPoly(V(a) * V(b) + V(c), len(levels)) for a, b, c in comps))


def _columns(n, name, seed):
    """uint32 numpy columns of 2^n elements at the claim's levels."""
    rng = np.random.default_rng(seed)
    out = []
    for lvl in CLAIMS[name][0]:
        if lvl == tower.P1:
            col = rng.integers(0, 1 << 32, (1 << n) // 32, dtype=np.uint64)
        elif lvl == 6:
            col = rng.integers(0, 1 << 32, (1 << n, 2), dtype=np.uint64)
        else:
            col = rng.integers(0, 1 << (1 << lvl), 1 << n, dtype=np.uint64)
        out.append((lvl, col.astype(np.uint32)))
    return out


def _round_inputs(n, name, seed):
    zc = _claim(arith, zerocheck, n, name)
    k = uzc.compute_skip_rounds([zc])
    d = uzc._max_degree(zc)
    dom_log = max(1, ((d << k) - 1).bit_length())
    eq_pt = [random.Random(seed).getrandbits(128) for _ in range(n - k)]
    cols = _columns(n, name, seed)
    mls = [(lvl, torch.from_numpy(c.view(np.int32).copy())) for lvl, c in cols]
    return zc, cols, mls, eq_pt, k, d, dom_log


@pytest.fixture
def routed(monkeypatch):
    """The shapes `bitsliced_ntt.transform` was called with."""
    calls = []
    transform = bitsliced_ntt.transform

    def spy(domain, data, data_level, shape, *a, **kw):
        calls.append((data_level, tuple(shape)))
        return transform(domain, data, data_level, shape, *a, **kw)

    monkeypatch.setattr(bitsliced_ntt, "transform", spy)
    return calls


@pytest.mark.parametrize("name", ["b32x4", "b32x3", "b1_b64"])
def test_routed_round_evals_match_reference_and_stage_loop(name, routed, monkeypatch):
    n = 13
    zc, cols, mls, eq_pt, k, d, dom_log = _round_inputs(n, name, seed=len(name))
    assert k == 7
    got = uzc._claim_round_evals(zc, mls, eq_pt, k, d, dom_log)
    m_pad = 1 << (len(mls) - 1).bit_length()
    assert m_pad << n == 1 << 15
    # B32 data, or B128 for a B64 column: the inverse and one forward
    data_level = 5 if name.startswith("b32") else 7
    assert routed == [(data_level, (0, k, (m_pad << (n - k)).bit_length() - 1))] * d
    jmls = [(lvl, jnp.asarray(c)) for lvl, c in cols]
    want = np.asarray(juzc._claim_round_evals(_claim(jarith, jzc, n, name), jmls, eq_pt, k, d,
                                              dom_log))
    assert got.numpy().view(np.uint32).tobytes() == want.tobytes()
    # the port's stage loop on the same rows
    monkeypatch.setattr(bitsliced_ntt, "supported", lambda *a: False)
    routed.clear()
    loop = uzc._claim_round_evals(zc, mls, eq_pt, k, d, dom_log)
    assert routed == []
    assert torch.equal(loop, got)


@pytest.mark.parametrize("name,n", [("b32x4", 13), ("b32x3", 13), ("b1_b64", 13),
                                    ("b32x4", 12), ("b1_b64", 12), ("b16x4", 13),
                                    ("u32_add", 13), ("u32_add", 9)])
def test_route_taken_where_wants_dispatch_admits(name, n, routed, monkeypatch):
    zc, cols, mls, eq_pt, k, d, dom_log = _round_inputs(n, name, seed=n)
    data_level = uzc.LEVEL if any(lvl > 5 for lvl, _ in mls) else max(
        [uzc.DOMAIN_LEVEL, *[max(lvl, 0) for lvl, _ in mls]])
    m_pad = 1 << (len(mls) - 1).bit_length()
    # the JAX package's batch: every suffix in one chunk at these sizes
    batch = m_pad << n
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(jbn.tower, "NO_PALLAS", False)
    operand = types.SimpleNamespace(ndim=2 if data_level > 5 else 1, shape=(batch,))
    admitted = jbn.wants_dispatch(juzc.DOMAIN_LEVEL, data_level, operand)
    uzc._claim_round_evals(zc, mls, eq_pt, k, d, dom_log)
    assert routed == ([(data_level, (0, k, batch.bit_length() - 1 - k))] * d if admitted else [])
    assert admitted == (name in ("b32x4", "b32x3", "b1_b64") and n == 13)


@pytest.mark.parametrize("circuit", ["b32_mul", "div_uu32"])
def test_routed_proof_keeps_golden_digest(circuit, routed, monkeypatch):
    """The gate lowered to one word: the commit and every stage-1 chunk
    with B32 or wider data take the bitsliced plain path."""
    monkeypatch.setattr(bitsliced_ntt, "MIN_ELEMS", 32)
    size, n_bytes, sha = chip_smoke.GOLDEN_CIRCUITS[circuit]
    core, witness, stmt = circuits.instance(circuit, size, 0, "cpu")
    proof = csp.prove(core, witness, log_inv_rate=1, device="cpu", **stmt)
    k = csp._zerocheck_skip(core)
    assert any(dl >= 5 and shape[:2] == (0, k) and shape[2] > 0 for dl, shape in routed)
    assert (len(proof), hashlib.sha256(proof).hexdigest()) == (n_bytes, sha)

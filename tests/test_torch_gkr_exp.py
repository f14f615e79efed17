"""The port's GKR exponentiation on the CPU against the JAX package's.

The same numpy bits (and dynamic base) go to both packages' `ExpWitness`:
every layer of the static and the dynamic circuit, at B64 and B128, with
bits given one per element (3 variables) and bits unpacked from P1 words
(7 variables, as the witness of a 2^7-row table holds them), must be equal
bit for bit. The port's `gkr_exp.batch_prove` over a static and a dynamic
claim is read back by the JAX package's `gkr_exp.batch_verify` (host
code) and the port's own, with equal bit and base claims; a wrong result
evaluation is rejected by both verifiers. Exact comparisons throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from binius_tpu.fields import tower as jtower
from binius_tpu.protocols import gkr_exp as jexp
from binius_tpu.transcript.transcript import VerifierTranscript as JVerifier
from binius_tpu_torch.fields import scalar, tower
from binius_tpu_torch.math import mle
from binius_tpu_torch.protocols import gkr_exp
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript

torch.set_num_threads(1)  # the suite's test processes share the cores

N_BITS = 5


def _bits(n_vars: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, 1 << n_vars).astype(np.uint32) for _ in range(N_BITS)]


def _port_bits(bits: list[np.ndarray], n_vars: int) -> list[torch.Tensor]:
    """Level-0 tensors; from 2^7 elements on, unpacked from P1 words."""
    out = []
    for b in bits:
        t = tower.from_numpy(0, b, "cpu")
        if n_vars >= tower.P1_MIN_VARS:
            lvl, t = tower.resolve_p1(*tower.maybe_pack_b1(0, t))
            assert lvl == 0
        out.append(t)
    return out


def _base(level: int, n_vars: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 100)
    return rng.integers(0, 1 << 32, (1 << n_vars, 1 << (level - 5))).astype(np.uint32)


@pytest.mark.parametrize("kind", ["static", "dynamic"])
@pytest.mark.parametrize("level", [6, 7])
@pytest.mark.parametrize("n_vars", [3, 7])
def test_exp_layers_match_reference(kind, level, n_vars):
    bits = _bits(n_vars, n_vars + level)
    jbits = [jnp.asarray(b) for b in bits]
    if kind == "static":
        g = scalar.GENERATORS[level]
        ours = gkr_exp.ExpWitness.static(n_vars, g, _port_bits(bits, n_vars), level=level)
        theirs = jexp.ExpWitness.static(n_vars, g, jbits, level=level)
    else:
        base = _base(level, n_vars, n_vars)
        ours = gkr_exp.ExpWitness.dynamic(n_vars, (level, tower.from_numpy(level, base, "cpu")),
                                          _port_bits(bits, n_vars), level=level)
        theirs = jexp.ExpWitness.dynamic(n_vars, (level, jtower.from_numpy(level, base)),
                                         jbits, level=level)
    assert ours.layers.shape[0] == N_BITS
    assert np.array_equal(ours.layers.numpy().view(np.uint32),
                          np.asarray(theirs.layers).view(np.uint32))


def _eval(level: int, data: torch.Tensor, n_vars: int, point: list[int]) -> int:
    _, v = mle.evaluate(level, data, n_vars, 7, tower.from_ints(7, point, "cpu"))
    return tower.to_ints(7, v[None])[0]


@pytest.fixture(scope="module")
def claims_and_witnesses():
    """A static claim of 4 variables and a dynamic one of 3 whose base is
    a static result, at B64, each on a random point."""
    rng = np.random.default_rng(7)
    bits4, bits3 = _bits(4, 1), _bits(3, 2)
    g = scalar.GENERATORS[6]
    w_s = gkr_exp.ExpWitness.static(4, g, _port_bits(bits4, 4), level=6)
    base = gkr_exp.ExpWitness.static(3, g, _port_bits(bits3[::-1], 3), level=6).result
    w_d = gkr_exp.ExpWitness.dynamic(3, (6, base), _port_bits(bits3, 3), level=6)
    pts = [[int.from_bytes(rng.bytes(16), "little") for _ in range(n)] for n in (4, 3)]
    claims = [gkr_exp.StaticExpClaim(4, N_BITS, g, tuple(pts[0]), _eval(6, w_s.result, 4, pts[0])),
              gkr_exp.DynamicExpClaim(3, N_BITS, tuple(pts[1]), _eval(6, w_d.result, 3, pts[1]))]
    return claims, [w_s, w_d]


def _jax_claim(c):
    if isinstance(c, gkr_exp.StaticExpClaim):
        return jexp.StaticExpClaim(c.n_vars, c.n_bits, c.base, c.eval_point, c.eval)
    return jexp.DynamicExpClaim(c.n_vars, c.n_bits, c.eval_point, c.eval)


def test_batch_prove_read_by_both_verifiers(claims_and_witnesses):
    claims, witnesses = claims_and_witnesses
    pt = ProverTranscript()
    out = gkr_exp.batch_prove(claims, witnesses, pt)
    proof = pt.finalize()
    ours = gkr_exp.batch_verify(claims, VerifierTranscript(proof))
    jt = JVerifier(proof)
    theirs = jexp.batch_verify([_jax_claim(c) for c in claims], jt)
    jt.finalize()
    assert out.bit_claims == ours.bit_claims == theirs.bit_claims
    assert out.base_claims == ours.base_claims == theirs.base_claims
    # 5 bit claims per circuit, 5 base claims on the dynamic one
    assert [len(b) for b in out.bit_claims] == [N_BITS, N_BITS]
    assert [len(b) for b in out.base_claims] == [0, N_BITS]
    # each bit claim holds on its bit column, each base claim on the base
    for (n, w), bit_claims in zip(((4, witnesses[0]), (3, witnesses[1])), out.bit_claims):
        for bi, point, ev in bit_claims:
            assert _eval(0, w.bits[bi], n, list(point)) == ev
    for point, ev in out.base_claims[1]:
        assert _eval(6, witnesses[1].base[1], 3, list(point)) == ev


def test_wrong_eval_rejected_by_both_verifiers(claims_and_witnesses):
    claims, witnesses = claims_and_witnesses
    c = claims[0]
    bad = [gkr_exp.StaticExpClaim(c.n_vars, c.n_bits, c.base, c.eval_point, c.eval ^ 1),
           claims[1]]
    pt = ProverTranscript()
    gkr_exp.batch_prove(bad, witnesses, pt)
    proof = pt.finalize()
    with pytest.raises(ValueError):
        gkr_exp.batch_verify(bad, VerifierTranscript(proof))
    with pytest.raises(ValueError):
        jexp.batch_verify([_jax_claim(c) for c in bad], JVerifier(proof))

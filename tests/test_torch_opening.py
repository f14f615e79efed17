"""The ported commitment opening end to end: commit, `ring_switch.prove`,
`piop.prove` in binius_tpu_torch (plain versions on the CPU) against the
JAX package on the same seeded inputs, at the shapes of
`tests/test_ring_switch.py::test_full_commitment_opening_slice` (B1 over 8
variables, B32 over 5, B8 over 7). The proof bytes must be equal, the
port's verifiers must accept the JAX proof, and one flipped byte must be
rejected. The JAX opening runs once, in the module fixture."""

import numpy as np
import pytest
import torch

from binius_tpu.fields import tower as jtower
from binius_tpu.protocols import fri as jfri
from binius_tpu.protocols import piop as jpiop
from binius_tpu.protocols import ring_switch as jring_switch
from binius_tpu.transcript import transcript as jtranscript
from binius_tpu_torch.convert import (claims_from_reference, fri_params_from_reference,
                                      from_reference)
from binius_tpu_torch.fields import scalar
from binius_tpu_torch.protocols import piop, ring_switch
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript

torch.set_num_threads(1)  # the suite's test processes share the cores

SHAPES = ((0, 8), (5, 5), (3, 7))    # (level, n_vars) of the committed columns
META = (0, 1, 0, 2)
FRI = dict(log_dim=3, log_inv_rate=1, log_batch_size=2, fold_arities=(2, 2), n_test_queries=3)


def _mle_eval(level, vals, point):
    """Host evaluation of a multilinear at a B128 point (scalar oracle)."""
    cur = [int(v) for v in vals]
    for r in point:
        cur = [cur[2 * i] ^ scalar.mul(7, cur[2 * i] ^ cur[2 * i + 1], r)
               for i in range(len(cur) // 2)]
    return cur[0]


@pytest.fixture(scope="module")
def opening():
    rng = np.random.default_rng(31)
    cols = [rng.integers(0, 1 << (1 << lvl), 1 << n, dtype=np.uint64).astype(np.uint32)
            for lvl, n in SHAPES]
    points = [[int.from_bytes(rng.bytes(16), "little") for _ in range(n)] for _, n in SHAPES]
    jclaims = [jring_switch.RingSwitchEvalClaim(i, lvl, tuple(pt), _mle_eval(lvl, c, pt))
               for i, ((lvl, n), c, pt) in enumerate(zip(SHAPES, cols, points))]
    jparams = jfri.FRIParams(**FRI)
    jmeta = jpiop.CommitMeta(META)
    jwit = [(lvl, jtower.from_numpy(lvl, c)) for (lvl, _), c in zip(SHAPES, cols)]
    jpacked = [jpiop.pack_multilinear(lvl, d, n) for (lvl, n), (_, d) in zip(SHAPES, jwit)]
    pt = jtranscript.ProverTranscript()
    cw, tree, _ = jpiop.commit(jparams, jmeta, jpacked)
    pt.message().write_bytes(tree.root)
    red = jring_switch.prove(jclaims, jwit, pt)
    jpiop.prove(jparams, jmeta, cw, tree, jpacked, red.transparent_mles, red.sumcheck_claims, pt)
    return cols, claims_from_reference(jclaims), fri_params_from_reference(jparams), pt.finalize()


def _prove(cols, claims, params):
    meta = piop.CommitMeta(META)
    wit = [(lvl, from_reference(c, "cpu")) for (lvl, _), c in zip(SHAPES, cols)]
    packed = [piop.pack_multilinear(lvl, d, n) for (lvl, n), (_, d) in zip(SHAPES, wit)]
    pt = ProverTranscript()
    cw, tree, _ = piop.commit(params, meta, packed, device="cpu")
    pt.message().write_bytes(tree.root)
    red = ring_switch.prove(claims, wit, pt, device="cpu")
    piop.prove(params, meta, cw, tree, packed, red.transparent_mles, red.sumcheck_claims, pt,
               device="cpu")
    return pt.finalize()


def _verify(proof, claims, params):
    vt = VerifierTranscript(proof)
    com = vt.message().read_bytes(32)
    red = ring_switch.verify(claims, vt, device="cpu")
    piop.verify(params, piop.CommitMeta(META), com, red.transparent_mles, red.sumcheck_claims, vt)
    vt.finalize()


def test_proof_bytes_match_reference(opening):
    cols, claims, params, jproof = opening
    assert _prove(cols, claims, params) == jproof


def test_port_verifies_reference_proof(opening):
    _, claims, params, jproof = opening
    _verify(jproof, claims, params)


@pytest.mark.parametrize("where", [0.25, 0.5, 0.9])
def test_flipped_byte_rejected(opening, where):
    _, claims, params, jproof = opening
    bad = bytearray(jproof)
    bad[int(len(bad) * where)] ^= 1
    with pytest.raises((ValueError, EOFError)):
        _verify(bytes(bad), claims, params)

"""The port's Fiat-Shamir transcript and incremental Grøstl-256 against the
JAX package's: the same writes and samples give the same tape, the same
challenges and the same digests, over the Grøstl-256 challenger and the
SHA-256 one."""

import numpy as np
import torch

from binius_tpu.hash import groestl as jgroestl
from binius_tpu.transcript import fiat_shamir as jfiat_shamir
from binius_tpu.transcript import transcript as jtranscript
from binius_tpu_torch.hash import groestl
from binius_tpu_torch.transcript import fiat_shamir
from binius_tpu_torch.transcript.transcript import ProverTranscript, VerifierTranscript

torch.set_num_threads(1)  # the suite's test processes share the cores


def _script(t, rng):
    """A fixed mix of message, decommitment and observe writes and of
    samples; returns what was sampled."""
    out = []
    for step in range(12):
        kind = step % 4
        if kind == 0:
            t.message().write_scalars(7, [int.from_bytes(rng.bytes(16), "little")
                                          for _ in range(step % 3 + 1)])
        elif kind == 1:
            t.decommitment().write_bytes(rng.bytes(40 + step))
        elif kind == 2:
            t.observe().write_bytes(rng.bytes(70))
        else:
            t.message()   # an empty message still switches the challenger
        out.append(t.sample_scalars(7, step % 3))
        out.append(t.sample_scalar(3))
        out.append(t.sample_bits(step + 5))
    return out


def test_prover_transcript_matches_reference():
    pt, jpt = ProverTranscript(), jtranscript.ProverTranscript()
    assert _script(pt, np.random.default_rng(7)) == _script(jpt, np.random.default_rng(7))
    assert pt.finalize() == jpt.finalize()


def test_verifier_reads_back_the_reference_tape():
    jpt = jtranscript.ProverTranscript()
    w = jpt.message()
    w.write_scalars(7, [3, 1 << 100])
    w.write_u64(12345)
    s = jpt.sample_scalars(7, 2)
    jpt.decommitment().write_bytes(b"advice")
    s.append(jpt.sample_bits(19))
    vt = VerifierTranscript(jpt.finalize())
    r = vt.message()
    assert r.read_scalars(7, 2) == [3, 1 << 100]
    assert r.read_u64() == 12345
    got = vt.sample_scalars(7, 2)
    assert vt.decommitment().read_bytes(6) == b"advice"
    got.append(vt.sample_bits(19))
    assert got == s
    vt.finalize()


def test_incremental_groestl_matches_reference():
    rng = np.random.default_rng(3)
    for n in (0, 1, 63, 64, 65, 200):
        data = rng.bytes(n)
        h = groestl.Groestl256().update(data[:n // 3])
        c = h.copy().update(data[n // 3:])
        assert c.finalize() == jgroestl.groestl256(data) == groestl.groestl256(data)
        assert h.finalize() == jgroestl.groestl256(data[:n // 3])


def test_sha256_challenger_sample_stream():
    """Observe and sample in turns over the SHA-256 challenger: the same
    bytes as the JAX package's, and not the Grøstl challenger's."""
    rng = np.random.default_rng(11)
    ch, jch = fiat_shamir.HasherChallenger("sha256"), jfiat_shamir.HasherChallenger("sha256")
    out, jout = [], []
    for n_obs, n_sample in ((0, 5), (33, 40), (1, 32), (64, 3), (0, 70)):
        data = rng.bytes(n_obs)
        for c, o in ((ch, out), (jch, jout)):
            if n_obs:
                c.observe(data)
            o.append(c.sample(n_sample))
    assert out == jout
    assert out[0] != fiat_shamir.HasherChallenger().sample(5)
    assert sorted(fiat_shamir.HASHES) == sorted(jfiat_shamir.HASHES)


def test_sha256_transcript_round_trip():
    """A SHA-256 transcript: the port's tape and samples equal the JAX
    package's; the port's and the JAX package's verifier transcripts read
    the port's tape back with the prover's challenges, and a Grøstl one
    draws others."""
    pt, jpt = ProverTranscript("sha256"), jtranscript.ProverTranscript("sha256")
    assert _script(pt, np.random.default_rng(9)) == _script(jpt, np.random.default_rng(9))
    assert pt.finalize() == jpt.finalize()
    pt = ProverTranscript(hash_name="sha256")
    w = pt.message()
    w.write_scalars(7, [5, 1 << 90])
    w.write_u64(77)
    s = pt.sample_scalars(7, 2)
    pt.decommitment().write_bytes(b"advice")
    s.append(pt.sample_bits(21))
    tape = pt.finalize()
    for vt in (VerifierTranscript(tape, "sha256"), jtranscript.VerifierTranscript(tape, "sha256")):
        r = vt.message()
        assert r.read_scalars(7, 2) == [5, 1 << 90]
        assert r.read_u64() == 77
        got = vt.sample_scalars(7, 2)
        assert vt.decommitment().read_bytes(6) == b"advice"
        got.append(vt.sample_bits(21))
        assert got == s
        vt.finalize()
    vt = VerifierTranscript(tape)
    vt.message().read_bytes(40)
    assert vt.sample_scalars(7, 2) != s[:2]

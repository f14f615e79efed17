"""Dual-tape proof transcript (Fiat-Shamir).

The port's copy of `binius_tpu/transcript/transcript.py` (a Grøstl-256
challenger unless `hash_name` names "sha256"), which mirrors
`crates/core/src/transcript/mod.rs`: one combined FIFO byte tape;
``message`` data is written/read AND observed into the challenger,
``decommitment`` (advice) data is written/read without observation, and
``observe`` absorbs without touching the tape. Field sampling deserializes
canonical-tower little-endian bytes; ``sample_bits`` reads 4 LE bytes masked
to the requested width (`transcript/mod.rs:448-506`).
"""

from __future__ import annotations

from . import serialization as ser
from .fiat_shamir import HasherChallenger


class _Writer:
    def __init__(self, transcript, observe: bool, write: bool):
        self._t = transcript
        self._observe = observe
        self._write = write
        if observe:
            # the reference transitions the challenger to observer mode when
            # the writer is OBTAINED (`challenger.observer()`,
            # `fiat_shamir/hasher_challenger.rs:65-76`) — even if zero bytes
            # are then written (e.g. an empty zerocheck round message)
            transcript._challenger.observe(b"")

    def write_bytes(self, data: bytes) -> None:
        if self._write:
            self._t._tape.extend(data)
        if self._observe:
            self._t._challenger.observe(data)

    def write_scalar(self, level: int, value: int) -> None:
        self.write_bytes(ser.serialize_scalar(level, value))

    def write_scalars(self, level: int, values) -> None:
        self.write_bytes(ser.serialize_scalars(level, values))

    def write_u64(self, v: int) -> None:
        self.write_bytes(int(v).to_bytes(8, "little"))


class _Reader:
    def __init__(self, transcript, observe: bool):
        self._t = transcript
        self._observe = observe
        if observe:
            # mirror the writer: observer-mode transition at creation
            transcript._challenger.observe(b"")

    def read_bytes(self, n: int) -> bytes:
        t = self._t
        if t._pos + n > len(t._tape):
            raise EOFError("transcript exhausted")
        data = bytes(t._tape[t._pos:t._pos + n])
        t._pos += n
        if self._observe:
            t._challenger.observe(data)
        return data

    def read_scalar(self, level: int) -> int:
        return ser.deserialize_scalar(level, self.read_bytes(ser.scalar_n_bytes(level)))

    def read_scalars(self, level: int, n: int) -> list[int]:
        w = ser.scalar_n_bytes(level)
        return ser.deserialize_scalars(level, self.read_bytes(w * n), n)

    def read_u64(self) -> int:
        return int.from_bytes(self.read_bytes(8), "little")


class ProverTranscript:
    def __init__(self, hash_name: str = "groestl256"):
        self._tape = bytearray()
        self._challenger = HasherChallenger(hash_name)

    def message(self) -> _Writer:
        return _Writer(self, observe=True, write=True)

    def decommitment(self) -> _Writer:
        return _Writer(self, observe=False, write=True)

    def observe(self) -> _Writer:
        return _Writer(self, observe=True, write=False)

    def sample_scalar(self, level: int) -> int:
        return ser.deserialize_scalar(
            level, self._challenger.sample(ser.scalar_n_bytes(level)))

    def sample_scalars(self, level: int, n: int) -> list[int]:
        return [self.sample_scalar(level) for _ in range(n)]

    def sample_bits(self, bits: int) -> int:
        raw = int.from_bytes(self._challenger.sample(4), "little")
        bits = min(bits, 32)
        mask = (1 << bits) - 1 if bits < 32 else 0xFFFFFFFF
        return raw & mask

    def finalize(self) -> bytes:
        return bytes(self._tape)


class VerifierTranscript:
    def __init__(self, proof: bytes, hash_name: str = "groestl256"):
        self._tape = proof
        self._pos = 0
        self._challenger = HasherChallenger(hash_name)

    def message(self) -> _Reader:
        return _Reader(self, observe=True)

    def decommitment(self) -> _Reader:
        return _Reader(self, observe=False)

    def observe(self) -> _Writer:
        return _Writer(self, observe=True, write=False)

    sample_scalar = ProverTranscript.sample_scalar
    sample_scalars = ProverTranscript.sample_scalars
    sample_bits = ProverTranscript.sample_bits

    def finalize(self) -> None:
        if self._pos != len(self._tape):
            raise ValueError(
                f"transcript not fully read: {len(self._tape) - self._pos} bytes left")

"""Fiat-Shamir challenger: `HasherChallenger` over Grøstl-256 (the default)
or SHA-256 (`crates/hash/src/sha2.rs`, the reference's other transcript
hash).

The port's copy of `binius_tpu/transcript/fiat_shamir.py`, the byte-exact
state machine of the reference `HasherChallenger<H>`:

  * starts in sampler mode with buffer = H("") and the running hasher
    already fed that digest;
  * sampler -> observer absorbs the sampler's byte index as 8 bytes,
    little-endian;
  * observer mode absorbs observed bytes into the running hasher;
  * observer -> sampler marks the buffer exhausted, so the next sample does
    digest = finalize(state); state = fresh; absorb(digest); buffer = digest.

Each observe and sample is a hot span of `utils.tracing`, "<phase>/transcript"
in a proof's table.
"""

from __future__ import annotations

import hashlib

from ..hash.groestl import Groestl256
from ..utils import tracing

DIGEST_SIZE = 32


class _Sha256:
    """digest::Digest-shaped adapter over hashlib (update, copy, finalize),
    the counterpart of the reference's sha2 re-export."""

    def __init__(self):
        self._h = hashlib.sha256()

    def update(self, data: bytes) -> "_Sha256":
        self._h.update(data)
        return self

    def copy(self) -> "_Sha256":
        out = _Sha256()
        out._h = self._h.copy()
        return out

    def finalize(self) -> bytes:
        return self._h.digest()


HASHES = {"groestl256": Groestl256, "sha256": _Sha256}


class HasherChallenger:
    def __init__(self, hash_name: str = "groestl256"):
        self._hash_cls = HASHES[hash_name]
        d = self._hash_cls().update(b"").finalize()
        self._hasher = self._hash_cls().update(d)
        self._mode = "sampler"
        self._buffer = d
        self._index = 0

    def observe(self, data: bytes) -> None:
        with tracing.span("transcript", hot=True):
            if self._mode == "sampler":
                self._hasher.update(self._index.to_bytes(8, "little"))
                self._mode = "observer"
            self._hasher.update(data)

    def sample(self, n: int) -> bytes:
        with tracing.span("transcript", hot=True):
            if self._mode == "observer":
                self._mode = "sampler"
                self._index = DIGEST_SIZE
                self._buffer = b""
            out = bytearray()
            while n > 0:
                if self._index == DIGEST_SIZE:
                    digest = self._hasher.copy().finalize()
                    self._hasher = self._hash_cls().update(digest)
                    self._buffer = digest
                    self._index = 0
                take = min(DIGEST_SIZE - self._index, n)
                out += self._buffer[self._index:self._index + take]
                self._index += take
                n -= take
            return bytes(out)

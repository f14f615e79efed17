"""Fiat-Shamir challenger: `HasherChallenger` over Grøstl-256.

The port's copy of `binius_tpu/transcript/fiat_shamir.py` (Grøstl only),
the byte-exact state machine of the reference `HasherChallenger<H>`:

  * starts in sampler mode with buffer = H("") and the running hasher
    already fed that digest;
  * sampler -> observer absorbs the sampler's byte index as 8 bytes,
    little-endian;
  * observer mode absorbs observed bytes into the running hasher;
  * observer -> sampler marks the buffer exhausted, so the next sample does
    digest = finalize(state); state = fresh; absorb(digest); buffer = digest.
"""

from __future__ import annotations

from ..hash.groestl import Groestl256

DIGEST_SIZE = 32


class HasherChallenger:
    def __init__(self):
        d = Groestl256().update(b"").finalize()
        self._hasher = Groestl256().update(d)
        self._mode = "sampler"
        self._buffer = d
        self._index = 0

    def observe(self, data: bytes) -> None:
        if self._mode == "sampler":
            self._hasher.update(self._index.to_bytes(8, "little"))
            self._mode = "observer"
        self._hasher.update(data)

    def sample(self, n: int) -> bytes:
        if self._mode == "observer":
            self._mode = "sampler"
            self._index = DIGEST_SIZE
            self._buffer = b""
        out = bytearray()
        while n > 0:
            if self._index == DIGEST_SIZE:
                digest = self._hasher.copy().finalize()
                self._hasher = Groestl256().update(digest)
                self._buffer = digest
                self._index = 0
            take = min(DIGEST_SIZE - self._index, n)
            out += self._buffer[self._index:self._index + take]
            self._index += take
            n -= take
        return bytes(out)

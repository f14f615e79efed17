"""Canonical-tower byte serialization of field elements (the port's copy of
`binius_tpu/transcript/serialization.py`).

Mirrors `SerializationMode::CanonicalTower` semantics
(`crates/utils/src/serialization.rs`): a tower element of level k serializes
as its canonical integer in ceil(2^k / 8) little-endian bytes (min 1 byte).
"""

from __future__ import annotations


def scalar_n_bytes(level: int) -> int:
    return max(1, (1 << level) // 8)


def serialize_scalar(level: int, value: int) -> bytes:
    return int(value).to_bytes(scalar_n_bytes(level), "little")


def deserialize_scalar(level: int, data: bytes) -> int:
    return int.from_bytes(data[:scalar_n_bytes(level)], "little")


def serialize_scalars(level: int, values) -> bytes:
    return b"".join(serialize_scalar(level, v) for v in values)


def deserialize_scalars(level: int, data: bytes, n: int) -> list[int]:
    w = scalar_n_bytes(level)
    return [int.from_bytes(data[i * w:(i + 1) * w], "little") for i in range(n)]

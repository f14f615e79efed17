"""Witness values of the `u32_add` gadget (host, numpy).

Counterpart of `U32Add.populate` in `binius_tpu/m3/gadgets/arith.py`: with
one u32 per row, a B1 column's P1 words are the row values themselves, so
the four committed columns xin, yin, zout and cout are uint32 arrays.
"""

from __future__ import annotations

import numpy as np


def u32_add_populate(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(zout, cout) words for rows x + y: carry-in word = (x+y) ^ x ^ y,
    carry-out = carry-in >> 1 with the bit-32 overflow at position 31."""
    x = x.astype(np.uint64)
    y = y.astype(np.uint64)
    full = x + y
    cin = full ^ x ^ y
    cout = ((cin >> np.uint64(1)) & np.uint64(0x7FFFFFFF)) | ((full >> np.uint64(32)) << np.uint64(31))
    return (full & np.uint64(0xFFFFFFFF)).astype(np.uint32), cout.astype(np.uint32)


def u32_add_columns(log_rows: int, seed: int) -> list[np.ndarray]:
    """The committed columns [xin, yin, zout, cout] of a 2^log_rows-row
    table with random inputs drawn from `seed`, as uint32 P1 words."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, 1 << log_rows, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, 1 << log_rows, dtype=np.uint64)
    z, cout = u32_add_populate(x, y)
    return [x.astype(np.uint32), y.astype(np.uint32), z, cout]

"""The statement's own columns against the values a proof claims for them.

After `verifier.verify` accepts a proof, the proof has bound each claimed
value to the commitment. Here each value is held against the multilinear
extension of the reference's own column at the same point, so a proof of
another statement (another witness that satisfies the same constraints)
fails.

A committed B1 column of 2^(log_rows + log_width) bits holds one word of
2^log_width bits per row, the bit index the low variables. At a point
(lo, hi): MLE = sum_b eq(lo, b) * S_b with S_b = XOR of eq(hi, row) over the
rows whose bit b is set. Per distinct hi, eq(hi, .) is expanded on `device`
(multiplication by each coordinate as 16 byte tables) and S is one float32
matrix product, the columns' bits by eq(hi)'s 128 bit planes, taken mod 2
(sums of at most 2^24 ones are exact in float32); the rest runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as F


def _eq_expand(point: list[int], device) -> torch.Tensor:
    """eq(point, v) for every v as (2^len(point), 2) int64 (lo, hi) limbs."""
    out = torch.tensor([[1, 0]], dtype=torch.int64, device=device)
    for r in point:
        tables = torch.from_numpy(F.ScalarMul(r).tables.view(np.int64)).to(device)
        hi = torch.zeros_like(out)
        for k in range(16):
            byte = (out[:, k // 8] >> (8 * (k % 8))) & 0xFF
            hi ^= tables[k][byte]
        out = torch.cat([out ^ hi, hi])
    return out


def _bits(words: torch.Tensor, width: int) -> torch.Tensor:
    """(n,) int64 words -> (n, width) float32 bits, bit b of each word."""
    shifts = torch.arange(width, device=words.device)
    return ((words[:, None] >> shifts) & 1).to(torch.float32)


def _pack128(bits: np.ndarray) -> np.ndarray:
    """(..., 128) {0, 1} -> (..., 2) uint64 pairs."""
    raw = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    return np.ascontiguousarray(raw).view("<u8").astype(np.uint64)


def mismatches(claims: list[tuple], columns: dict, log_width: int,
               device: torch.device) -> int:
    """claims: [(oracle id, point, value)] on committed B1 columns; columns:
    oracle id -> (rows,) uint64 words. Returns how many values differ from
    the columns' own multilinear extensions (a claim on a column the
    statement does not have counts as differing)."""
    width = 1 << log_width
    bad = sum(1 for oid, _, _ in claims if oid not in columns)
    by_hi: dict = {}
    for oid, pt, val in claims:
        if oid in columns:
            by_hi.setdefault(tuple(pt[log_width:]), []).append((oid, tuple(pt[:log_width]), val))
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for hi, group in by_hi.items():
            eq = _eq_expand(list(hi), device)
            eq_bits = torch.cat([_bits(eq[:, 0], 64), _bits(eq[:, 1], 64)], dim=1)
            del eq
            oids = list(dict.fromkeys(oid for oid, _, _ in group))
            s = torch.empty((len(oids), width, 128), dtype=torch.float32)
            for i, o in enumerate(oids):
                words = torch.from_numpy(np.ascontiguousarray(columns[o]).view(np.int64))
                s[i] = (_bits(words.to(device), width).T @ eq_bits).remainder_(2).cpu()
            s = _pack128(s.numpy())
            del eq_bits
            row_of = {o: i for i, o in enumerate(oids)}
            by_lo: dict = {}
            for oid, lo, val in group:
                by_lo.setdefault(lo, []).append((row_of[oid], val))
            for lo, members in by_lo.items():
                idx = np.array([i for i, _ in members])
                acc = np.zeros((len(members), 2), dtype=np.uint64)
                for b, e in enumerate(F.eq_expand(list(lo))):
                    acc ^= F.ScalarMul(e)(s[idx, b])
                bad += sum(F.from_pair(p) != v for p, (_, v) in zip(acc, members))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return bad

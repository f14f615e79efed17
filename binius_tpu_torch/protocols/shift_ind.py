"""Shift indicator transparent polynomials.

The port of `binius_tpu/protocols/shift_ind.py`:

  * CircularLeft(o):  shifted[i] = f[(i-o) mod 2^b]
  * LogicalLeft(o):   shifted[i] = f[i-o]   (0 when i < o), "value << o"
  * LogicalRight(o):  shifted[i] = f[i+o]   (0 when i+o >= 2^b)

shift_ind(x, y) = 1 iff reading f at y contributes to shifted at x. The
evaluation at field points (the verifier) and the partial multilinear
over y at a field point x (the prover) are carry DPs over the offset's
bits: `_ll_eval_scalar(b, o, A, B)` is the no-carry-out path of the
binary addition B = A + o; LogicalRight is (A, B) = (x, y), LogicalLeft
is (A, B) = (y, x), and CircularLeft = LogicalLeft(o) + LogicalRight(2^b -
o) (disjoint supports). A verifier wave's evaluations run as one carry
DP in the native host library's B128 batches (`scalar.mul_pairs`), the
prover's partial multilinears as tensors on its device.
`apply_shift_device` materializes a shifted column.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import ints_to_pairs, pairs_to_ints
from ..fields import scalar, tower

LEVEL = 7

CIRCULAR_LEFT = "circular_left"
LOGICAL_LEFT = "logical_left"
LOGICAL_RIGHT = "logical_right"


def _ll_transition(o_k: int, xb: int, c: int) -> tuple[int, int]:
    """For y = x + o: the required y bit and the carry out, given a bit of
    x and the carry in."""
    y_req = xb ^ o_k ^ c
    c_out = 1 if (xb + o_k + c) >= 2 else 0
    return y_req, c_out


def _ll_eval_scalar(b: int, o: int, x: list[int], y: list[int]) -> int:
    """The logical-left(o) indicator at field points x, y (b coordinates)."""
    s = [1, 0]   # weight accumulated with carry 0 / 1
    for k in range(b):
        o_k = (o >> k) & 1
        ns = [0, 0]
        for c in (0, 1):
            if s[c] == 0:
                continue
            for xb in (0, 1):
                wx = x[k] if xb else x[k] ^ 1
                y_req, c_out = _ll_transition(o_k, xb, c)
                wy = y[k] if y_req else y[k] ^ 1
                ns[c_out] ^= scalar.mul(LEVEL, s[c], scalar.mul(LEVEL, wx, wy))
        s = ns
    return s[0]


def evaluate_scalar(variant: str, b: int, o: int, x: list[int], y: list[int]) -> int:
    """shift_ind(x, y) at field points; x = shifted index point, y = inner
    index point."""
    if variant == LOGICAL_RIGHT:       # y = x + o
        return _ll_eval_scalar(b, o, x, y)
    if variant == LOGICAL_LEFT:        # x = y + o
        return _ll_eval_scalar(b, o, y, x)
    if variant == CIRCULAR_LEFT:       # y = (x - o) mod 2^b
        return _ll_eval_scalar(b, o, y, x) ^ _ll_eval_scalar(b, (1 << b) - o, x, y)
    raise ValueError(variant)


def _ll_eval_stacked(b: int, offsets: list[int], a: np.ndarray, bb: np.ndarray) -> list[int]:
    """`_ll_eval_scalar(b, o_i, a_i, b_i)` of E entries at once: a, bb
    (E, b, 2) uint64 pairs of B128 points. Each step evaluates both values
    of the offset's bit and selects per entry; its products are two C
    batches (`scalar.mul_pairs`)."""
    n = a.shape[0]
    one = np.array([1, 0], dtype=np.uint64)
    zero = np.uint64(0)
    s = [np.tile(one, (n, 1)), np.zeros((n, 2), dtype=np.uint64)]
    steps = [(c, xb) for c in (0, 1) for xb in (0, 1)]
    for k in range(b):
        obit = np.array([(o >> k) & 1 for o in offsets], dtype=bool)[:, None]
        sx = scalar.mul_pairs(LEVEL, np.concatenate(s), np.concatenate([a[:, k]] * 2))
        sx = [sx[:n], sx[n:]]                                     # s[c] * x
        wy = {1: bb[:, k], 0: bb[:, k] ^ one}
        terms = scalar.mul_pairs(LEVEL, np.concatenate(
            [sx[c] if xb else sx[c] ^ s[c] for c, xb in steps]), np.concatenate(
            [np.where(obit, wy[xb ^ c ^ 1], wy[xb ^ c]) for c, xb in steps]))
        ns = [np.zeros_like(s[0]), np.zeros_like(s[0])]
        for j, (c, xb) in enumerate(steps):
            term = terms[j * n:(j + 1) * n]
            # y's required bit is xb ^ o_k ^ c; the carry out is xb & c when
            # o_k = 0 and xb | c when o_k = 1
            c0, c1 = xb & c, xb | c
            if c0 == c1:
                ns[c0] ^= term
            else:
                ns[c0] ^= np.where(obit, zero, term)
                ns[c1] ^= np.where(obit, term, zero)
        s = ns
    return pairs_to_ints(s[0])


def evaluate_scalar_batch(variants: list[str], bs: list[int], offs: list[int],
                          x_points: list, y_points: list) -> list[int]:
    """`evaluate_scalar` of k claims (a verifier wave's shift checks) as one
    stacked carry DP per block size, on the host: a circular claim adds the
    complement offset's entry with the arguments swapped."""
    out = [0] * len(variants)
    by_b: dict = {}
    for i, b in enumerate(bs):
        by_b.setdefault(b, []).append(i)
    for b, idxs in by_b.items():
        entries = []   # (claim index, offset, first point, second point)
        for i in idxs:
            v, o, x, y = variants[i], offs[i], x_points[i], y_points[i]
            if v == LOGICAL_RIGHT:
                entries.append((i, o, x, y))
            elif v == LOGICAL_LEFT:
                entries.append((i, o, y, x))
            elif v == CIRCULAR_LEFT:
                entries.append((i, o, y, x))
                entries.append((i, (1 << b) - o, x, y))
            else:
                raise ValueError(v)
        if b == 0:
            vals = [1] * len(entries)
        else:
            pts = [[v for e in entries for v in e[j][:b]] for j in (2, 3)]
            a, bb = (ints_to_pairs(p).reshape(len(entries), b, 2) for p in pts)
            vals = _ll_eval_stacked(b, [e[1] for e in entries], a, bb)
        for (i, *_), v in zip(entries, vals):
            out[i] ^= v
    return out


def _partial_mle_stacked(b: int, offsets: list[int], xs: torch.Tensor,
                         y_adds: bool) -> torch.Tensor:
    """The multilinears over y (2^b B128 elements each) of the carry DP of
    k offsets at k field points xs (k, b, 4): (k, 2^b, 4). `y_adds` False
    is y = x + o (bits of y required), True is x = y + o (bits of x
    required). Each step evaluates both values of the offset's bit and
    selects per point."""
    k, dev = xs.shape[0], xs.device
    s = [tower.full(LEVEL, (k, 1), 1, dev), tower.zeros(LEVEL, (k, 1), dev)]
    for j in range(b):
        obit = torch.tensor([(o >> j) & 1 for o in offsets], dtype=torch.bool,
                            device=dev)[:, None, None]
        sx = tower.mul(LEVEL, torch.stack(s), xs[None, :, j:j + 1])   # s[c] * x
        prod = {(c, 1): sx[c] for c in (0, 1)}
        prod.update({(c, 0): sx[c] ^ s[c] for c in (0, 1)})           # s[c] * (x + 1)
        zero = torch.zeros_like(s[0])
        new = []
        for o_k in (0, 1):
            contrib: dict = {}
            for c in (0, 1):
                for other in (0, 1):
                    req, c_out = _ll_transition(o_k, other, c)
                    xbit, ybit = (req, other) if y_adds else (other, req)
                    key = (c_out, ybit)
                    t = prod[(c, xbit)]
                    contrib[key] = t if key not in contrib else contrib[key] ^ t
            new.append([torch.cat([contrib.get((co, 0), zero), contrib.get((co, 1), zero)], 1)
                        for co in (0, 1)])
        s = [torch.where(obit, new[1][co], new[0][co]) for co in (0, 1)]
    return s[0]


def partial_mle_batch(variants: list[str], b: int, offsets: list[int],
                      x_points: list[list[int]], device=None) -> torch.Tensor:
    """The multilinears over y of shift_ind(x_point, y) of k claims sharing
    block size b: (k, 2^b, 4) B128, one carry DP over all of them (per
    variant kind)."""
    xs = tower.from_ints(LEVEL, [v for pt in x_points for v in pt[:b]], device)
    xs = xs.reshape(len(variants), b, 4)
    out = tower.zeros(LEVEL, (len(variants), 1 << b), xs.device)
    for y_adds in (True, False):
        # LOGICAL_LEFT and CIRCULAR_LEFT(o) have an x = y + o part;
        # LOGICAL_RIGHT and CIRCULAR_LEFT's wrap (2^b - o) a y = x + o part
        idx, offs = [], []
        for i, (v, o) in enumerate(zip(variants, offsets)):
            if v not in (CIRCULAR_LEFT, LOGICAL_LEFT, LOGICAL_RIGHT):
                raise ValueError(v)
            if y_adds and v != LOGICAL_RIGHT:
                idx.append(i)
                offs.append(o)
            elif not y_adds and v != LOGICAL_LEFT:
                idx.append(i)
                offs.append(o if v == LOGICAL_RIGHT else (1 << b) - o)
        if idx:
            sel = torch.tensor(idx, dtype=torch.long, device=xs.device)
            out[sel] ^= _partial_mle_stacked(b, offs, xs[sel], y_adds)
    return out


def partial_mle(variant: str, b: int, o: int, x_point: list[int], device=None) -> torch.Tensor:
    """The multilinear over y of shift_ind(x_point, y): (2^b, 4) B128."""
    return partial_mle_batch([variant], b, [o], [x_point], device)[0]


def apply_shift_ints(variant: str, b: int, o: int, vals: list[int]) -> list[int]:
    """The shifted column of `vals` (Python ints), shifted within each block
    of 2^b entries: the reference semantics on the host."""
    size = 1 << b
    out = [0] * len(vals)
    for blk in range(0, len(vals), size):
        for i in range(size):
            if variant == CIRCULAR_LEFT:
                out[blk + i] = vals[blk + (i - o) % size]
            elif variant == LOGICAL_RIGHT:
                out[blk + i] = vals[blk + i + o] if i + o < size else 0
            elif variant == LOGICAL_LEFT:
                out[blk + i] = vals[blk + i - o] if i >= o else 0
            else:
                raise ValueError(variant)
    return out


def apply_shift_device(level: int, variant: str, b: int, o: int,
                       data: torch.Tensor) -> torch.Tensor:
    """The shifted column of `data` (canonical layout at `level`, not
    bit-packed), shifted within each block of 2^b elements."""
    n = tower.batch_shape(level, data)[0]
    size = 1 << b
    d = data.reshape(tower.elem_shape(level, (n // size, size)))
    if variant == CIRCULAR_LEFT:
        out = torch.roll(d, o, dims=1)
    elif variant == LOGICAL_RIGHT:
        out = torch.cat([d[:, o:], torch.zeros_like(d[:, :o])], dim=1)
    elif variant == LOGICAL_LEFT:
        out = torch.cat([torch.zeros_like(d[:, :o]), d[:, :size - o]], dim=1)
    else:
        raise ValueError(variant)
    return out.reshape(data.shape)


def apply_shift_words(variant: str, b: int, o: int, words: torch.Tensor) -> torch.Tensor:
    """`apply_shift_device` on bit-packed B1 words with blocks of 32 or 64
    bits (b = 5 or 6): each word, or little-endian pair of words, is one
    block, bit i holding element i."""
    assert b in (5, 6)
    w = 1 << b
    x = words if b == 5 else words.view(torch.int64)

    def right(v, k):   # logical right shift of a block by 0 < k < w
        return (v >> k) & ((1 << (w - k)) - 1)

    if variant == LOGICAL_LEFT:
        out = x << o
    elif variant == LOGICAL_RIGHT:
        out = right(x, o)
    elif variant == CIRCULAR_LEFT:
        out = (x << o) | right(x, w - o)
    else:
        raise ValueError(variant)
    return out if b == 5 else out.view(torch.int32)

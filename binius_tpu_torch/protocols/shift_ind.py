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
o) (disjoint supports). `apply_shift_device` materializes a shifted
column.
"""

from __future__ import annotations

import torch

from ..device import shr
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


def _partial_mle(b: int, o: int, xs: torch.Tensor, y_adds: bool) -> torch.Tensor:
    """The multilinear over y (2^b B128 elements) of the carry DP at the
    field point xs (b, 4): `y_adds` False is y = x + o (bits of y
    required), True is x = y + o (bits of x required)."""
    dev = xs.device
    s = {0: tower.full(LEVEL, (1,), 1, dev), 1: tower.zeros(LEVEL, (1,), dev)}
    one = tower.full(LEVEL, (), 1, dev)
    for k in range(b):
        o_k = (o >> k) & 1
        wx = {1: xs[k], 0: xs[k] ^ one}
        contrib: dict = {}
        for c in (0, 1):
            for other in (0, 1):
                req, c_out = _ll_transition(o_k, other, c)
                # y = x + o: branch on x's bit, y's bit is required;
                # x = y + o: branch on y's bit, x's bit is required
                xbit, ybit = (req, other) if y_adds else (other, req)
                term = tower.mul(LEVEL, s[c], wx[xbit])
                key = (c_out, ybit)
                contrib[key] = term if key not in contrib else contrib[key] ^ term
        zero = torch.zeros_like(s[0])
        s = {c_out: torch.cat([contrib.get((c_out, 0), zero), contrib.get((c_out, 1), zero)])
             for c_out in (0, 1)}
    return s[0]


def partial_mle(variant: str, b: int, o: int, x_point: list[int], device=None) -> torch.Tensor:
    """The multilinear over y of shift_ind(x_point, y): (2^b, 4) B128."""
    xs = tower.from_ints(LEVEL, x_point[:b], device)
    if variant == LOGICAL_RIGHT:       # y = x + o
        return _partial_mle(b, o, xs, False)
    if variant == LOGICAL_LEFT:        # x = y + o
        return _partial_mle(b, o, xs, True)
    if variant == CIRCULAR_LEFT:
        return _partial_mle(b, o, xs, True) ^ _partial_mle(b, (1 << b) - o, xs, False)
    raise ValueError(variant)


def partial_mle_batch(variants: list[str], b: int, offsets: list[int],
                      x_points: list[list[int]], device=None) -> torch.Tensor:
    """`partial_mle` of k claims sharing block size b: (k, 2^b, 4)."""
    return torch.stack([partial_mle(v, b, o, pt, device)
                        for v, o, pt in zip(variants, offsets, x_points)])


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


def apply_shift_words(variant: str, o: int, words: torch.Tensor) -> torch.Tensor:
    """`apply_shift_device` on bit-packed B1 words with blocks of 32 bits
    (b = 5): each word is one block, bit i holding element i."""
    if variant == LOGICAL_LEFT:
        return words << o
    if variant == LOGICAL_RIGHT:
        return shr(words, o)
    if variant == CIRCULAR_LEFT:
        return (words << o) | shr(words, 32 - o)
    raise ValueError(variant)

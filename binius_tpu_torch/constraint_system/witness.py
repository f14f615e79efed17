"""Witness index utilities: materialize virtual oracle columns on a device.

The port of `binius_tpu/constraint_system/witness.py`. A witness is a
dict: oracle id -> (tower level, tensor), B1 columns bit-packed
(`tower.P1`) where they are long enough. Ported kinds: transparent
(constants, patterns, step-down masks, structured columns), repeating,
linear combination, shifted and composite oracles (an XOR of bit-packed
B1 columns and a shift of one within 32- or 64-bit blocks work on the
packed words); packed, projected and zero-padded oracles raise
`NotImplementedError` (no ported circuit reaches them).
`materialize_stack` computes the values of many oracles of one size as
one B128 stack without caching them (the grand-product inputs).
"""

from __future__ import annotations

import torch

from ..fields import tower
from ..math.arith import ArithExpr
from ..protocols import shift_ind
from . import oracle as om

LEVEL = 7


def _int_level(v: int) -> int:
    """Smallest tower level whose subfield holds the canonical int `v`."""
    for lvl in range(8):
        if v < (1 << (1 << lvl)):
            return lvl
    raise ValueError(f"not a B128 element: {v}")


def _device(witness: dict):
    return next(iter(witness.values()))[1].device


def _packed_b1_combination(oracles: om.OracleSet, witness: dict, o: om.Oracle):
    """The packed words of a linear combination of bit-packed B1 columns
    with 0/1 coefficients and offset (an XOR of columns, as keccak's theta
    columns are), or None when the combination is not of that kind."""
    if o.lc_offset > 1 or any(c > 1 for c in o.lc_coeffs):
        return None
    for iid in o.inner:
        if iid not in witness:
            materialize(oracles, witness, iid)
    if not o.inner or any(witness[iid][0] != tower.P1 for iid in o.inner):
        return None
    acc = None
    for iid, coeff in zip(o.inner, o.lc_coeffs):
        if coeff:
            acc = witness[iid][1] if acc is None else acc ^ witness[iid][1]
    if acc is None:
        acc = torch.zeros_like(witness[o.inner[0]][1])
    return ~acc if o.lc_offset else acc


def materialize(oracles: om.OracleSet, witness: dict, oid: int):
    """(level, data) of an oracle, computing a virtual oracle from its inner
    witnesses and caching it into `witness` (bit-packed where it is B1).
    Returns the unpacked element-per-word view of a B1 column."""
    if oid in witness:
        return tower.resolve_p1(*witness[oid])
    o = oracles[oid]
    if o.variant == om.TRANSPARENT:
        out = o.transparent.mle(_device(witness))
    elif o.variant == om.REPEATING:
        ilvl, idata = materialize(oracles, witness, o.inner[0])
        out = (ilvl, idata.repeat(1 << o.log_degree, *[1] * (idata.ndim - 1)))
    elif o.variant == om.LINEAR_COMBINATION:
        words = _packed_b1_combination(oracles, witness, o)
        if words is not None:
            witness[oid] = (tower.P1, words)
            return tower.resolve_p1(*witness[oid])
        inner = [materialize(oracles, witness, iid) for iid in o.inner]
        dev = inner[0][1].device if inner else _device(witness)
        lc_level = max([_int_level(o.lc_offset), *(_int_level(c) for c in o.lc_coeffs),
                        *(ilvl for ilvl, _ in inner)])
        if lc_level <= 5:
            # the combination closes in a subfield: materialize it there
            acc = tower.full(lc_level, (1 << o.n_vars,), o.lc_offset, dev)
            for (ilvl, idata), coeff in zip(inner, o.lc_coeffs):
                x = tower.embed(ilvl, lc_level, idata)
                if coeff != 1:
                    x = tower.mul(lc_level, x, tower.full(lc_level, (), coeff, dev))
                acc = acc ^ x
            out = (lc_level, acc)
        else:
            acc = tower.full(LEVEL, (1 << o.n_vars,), o.lc_offset, dev)
            for (ilvl, idata), coeff in zip(inner, o.lc_coeffs):
                c = tower.full(LEVEL, (), coeff, dev)
                acc = acc ^ tower.scale_subfield(ilvl, LEVEL, idata, c)
            out = (LEVEL, acc)
    elif o.variant == om.SHIFTED:
        inner_id = o.inner[0]
        if inner_id not in witness:
            materialize(oracles, witness, inner_id)
        ilvl, idata = witness[inner_id]
        if ilvl == tower.P1 and o.shift_block_bits in (5, 6):
            # one block per packed word or pair of words: shift the words
            witness[oid] = (tower.P1, shift_ind.apply_shift_words(
                o.shift_variant, o.shift_block_bits, o.shift_offset, idata))
            return tower.resolve_p1(*witness[oid])
        ilvl, idata = tower.resolve_p1(ilvl, idata)
        out = (ilvl, shift_ind.apply_shift_device(
            ilvl, o.shift_variant, o.shift_block_bits, o.shift_offset, idata))
    elif o.variant == om.COMPOSITE:
        inner = [materialize(oracles, witness, iid) for iid in o.inner]
        expr = getattr(o.composite, "expr", o.composite)
        comp_level = max([expr.binary_tower_level(), *(ilvl for ilvl, _ in inner)])
        if comp_level <= 5:
            # the composition closes in a subfield: evaluate and store there
            out = (comp_level, expr.evaluate(
                comp_level, [tower.embed(ilvl, comp_level, d) for ilvl, d in inner]))
        else:
            out = (LEVEL, expr.evaluate(
                LEVEL, [tower.embed(ilvl, LEVEL, d) if ilvl < LEVEL else d
                        for ilvl, d in inner]))
    elif o.variant in (om.PACKED, om.PROJECTED, om.ZERO_PADDED):
        raise NotImplementedError(f"materializing a {o.variant} oracle is not ported")
    else:
        raise KeyError(f"cannot materialize oracle {oid} ({o.variant})")
    witness[oid] = tower.maybe_pack_b1(*out)
    return out


def _as_expression(oracles: om.OracleSet, oid: int):
    """(expression over var(i) = inner i, inner oracle ids) of an oracle:
    a composite's own, a linear combination's offset + sum c_i * var(i),
    any other oracle var(0) over itself."""
    o = oracles[oid]
    if o.variant == om.COMPOSITE:
        return getattr(o.composite, "expr", o.composite), o.inner
    if o.variant == om.LINEAR_COMBINATION:
        e = ArithExpr.const(o.lc_offset, 7)
        for i, c in enumerate(o.lc_coeffs):
            e = e + ArithExpr.const(c, 7) * ArithExpr.var(i)
        return e, o.inner
    return ArithExpr.var(0), (oid,)


def materialize_stack(oracles: om.OracleSet, witness: dict, oids: list) -> torch.Tensor:
    """The (m, 2^n, 4) B128 values of m oracles of n variables, which are
    not cached into `witness` (their inner oracles are). Oracles whose
    expressions have one shape (`sumcheck.prove.compact_compositions`:
    the flush oracles of one width and selector count share alpha, beta
    and the expression) evaluate as one expression over a gather of their
    inner columns, in chunks of members within the sumcheck's
    `STACKED_CHUNK_ELEMS`."""
    from ..protocols.sumcheck.prove import STACKED_CHUNK_ELEMS, _stack, compact_compositions

    n = oracles[oids[0]].n_vars
    assert all(oracles[oid].n_vars == n for oid in oids)
    specs = [_as_expression(oracles, oid) for oid in oids]
    groups: dict = {}
    for i, ((cexpr, used), (_, inner)) in enumerate(zip(
            compact_compositions([e for e, _ in specs]), specs)):
        groups.setdefault(cexpr, []).append((i, tuple(inner[u] for u in used)))
    dev = _device(witness)
    out = torch.empty((len(oids), 1 << n, 4), dtype=torch.int32, device=dev)
    for cexpr, members in groups.items():
        r = len(members[0][1])
        per = max(1, STACKED_CHUNK_ELEMS // (max(r, 1) << n))
        for c0 in range(0, len(members), per):
            chunk = members[c0:c0 + per]
            ids = list(dict.fromkeys(i for _, inner in chunk for i in inner))
            for i in ids:
                materialize(oracles, witness, i)
            pos = {i: p for p, i in enumerate(ids)}
            rows = _stack([witness[i] for i in ids], n)
            sub = rows[torch.tensor([[pos[i] for i in inner] for _, inner in chunk],
                                    dtype=torch.long, device=dev)]
            vals = cexpr.evaluate(LEVEL, [sub[:, k] for k in range(r)])
            idx = torch.tensor([i for i, _ in chunk], dtype=torch.long, device=dev)
            out[idx] = vals.expand(len(chunk), 1 << n, 4)
    return out

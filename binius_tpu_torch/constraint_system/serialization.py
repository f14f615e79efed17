"""Constraint-system serialization: the BTPUCS03 wire format.

The port of `binius_tpu/constraint_system/serialization.py`, byte for
byte: a system goes from the process that builds it to a verifier in
another process, which recomputes its digest. Length-prefixed
little-endian sections: each oracle's fields, expressions as postfix
token streams, transparents by a registered name and their parameters,
the constraint sets, flushes, non-zero claims and exponents, and at the
end the canonical (reference-format) symbolic system where the M3
builder made one, so the digest the proof observes survives the trip.

The format carries no bound values or start index of a projected
oracle and no surviving block of a zero-padded one. `deserialize` takes
a projected oracle's from the symbolic system where the system has one
(every projected oracle the M3 builder makes has it); the JAX package's
reader leaves them empty.
"""

from __future__ import annotations

import io
import struct

from ..math.arith import ArithExpr
from ..protocols import transparent as tp
from . import canonical
from . import oracle as om
from .exp import Exp
from .system import ConstraintSet, ConstraintSystem, Flush, NonZeroClaim

MAGIC = b"BTPUCS03"


def _w_u32(b, v):
    b.write(struct.pack("<I", v))


def _w_i32(b, v):
    b.write(struct.pack("<i", v))


def _w_u128(b, v):
    b.write(int(v).to_bytes(16, "little"))


def _w_str(b, s):
    raw = s.encode()
    _w_u32(b, len(raw))
    b.write(raw)


def _r_u32(r):
    return struct.unpack("<I", r.read(4))[0]


def _r_i32(r):
    return struct.unpack("<i", r.read(4))[0]


def _r_u128(r):
    return int.from_bytes(r.read(16), "little")


def _r_str(r):
    return r.read(_r_u32(r)).decode()


def _w_expr(b, e: ArithExpr) -> None:
    """Postfix token stream: c level value, v index, + and * after their
    operands, ^ exponent after its base."""
    stack = [(e, False)]
    while stack:
        node, done = stack.pop()
        if node.op == "const":
            b.write(b"c")
            _w_u32(b, node.level)
            _w_u128(b, node.value)
        elif node.op == "var":
            b.write(b"v")
            _w_u32(b, node.value)
        elif done:
            if node.op == "pow":
                b.write(b"^")
                _w_u32(b, node.value)
            else:
                b.write(b"+" if node.op == "add" else b"*")
        elif node.op in ("add", "mul", "pow"):
            stack.append((node, True))
            stack.extend((a, False) for a in reversed(node.args))
        else:
            raise ValueError(node.op)


def _serialize_expr(e: ArithExpr) -> bytes:
    b = io.BytesIO()
    _w_expr(b, e)
    return b.getvalue()


def _deserialize_expr(data: bytes) -> ArithExpr:
    r = io.BytesIO(data)
    stack = []
    while tok := r.read(1):
        if tok == b"c":
            lvl = _r_u32(r)
            stack.append(ArithExpr.const(_r_u128(r), lvl))
        elif tok == b"v":
            stack.append(ArithExpr.var(_r_u32(r)))
        elif tok in (b"+", b"*"):
            y, x = stack.pop(), stack.pop()
            stack.append(ArithExpr("add" if tok == b"+" else "mul", (x, y)))
        elif tok == b"^":
            stack.append(ArithExpr("pow", (stack.pop(),), _r_u32(r)))
        else:
            raise ValueError(tok)
    assert len(stack) == 1
    return stack[0]


def _w_transparent(b, t) -> None:
    if isinstance(t, tp.Constant):
        _w_str(b, "constant")
        _w_u32(b, t.n_vars)
        _w_u32(b, t.level)
        _w_u128(b, t.value)
    elif isinstance(t, tp.EqIndTransparent):
        _w_str(b, "eq_ind")
        _w_u32(b, len(t.point))
        for v in t.point:
            _w_u128(b, v)
    elif isinstance(t, (tp.StepDown, tp.StepUp)):
        _w_str(b, "step_down" if isinstance(t, tp.StepDown) else "step_up")
        _w_u32(b, t.n_vars)
        _w_u32(b, t.index)
    elif isinstance(t, tp.Powers):
        _w_str(b, "powers")
        _w_u32(b, t.n_vars)
        _w_u128(b, t.base)
    elif isinstance(t, tp.MLEFromValues):
        _w_str(b, "mle_values")
        _w_u32(b, t.level)
        _w_u32(b, len(t.values))
        for v in t.values:
            _w_u128(b, v)
    elif isinstance(t, tp.StructuredArith):
        _w_str(b, "structured")
        _w_u32(b, t.n_vars)
        _w_u32(b, t.level)
        raw = _serialize_expr(t.expr)
        _w_u32(b, len(raw))
        b.write(raw)
    else:
        raise ValueError(f"unregistered transparent {type(t)}")


def _r_transparent(r):
    kind = _r_str(r)
    if kind == "constant":
        n, lvl, v = _r_u32(r), _r_u32(r), _r_u128(r)
        return tp.Constant(n, v, lvl)
    if kind == "eq_ind":
        return tp.EqIndTransparent(tuple(_r_u128(r) for _ in range(_r_u32(r))))
    if kind == "step_down":
        return tp.StepDown(_r_u32(r), _r_u32(r))
    if kind == "step_up":
        return tp.StepUp(_r_u32(r), _r_u32(r))
    if kind == "powers":
        return tp.Powers(_r_u32(r), _r_u128(r))
    if kind == "mle_values":
        lvl = _r_u32(r)
        return tp.MLEFromValues(tuple(_r_u128(r) for _ in range(_r_u32(r))), lvl)
    if kind == "structured":
        n, lvl = _r_u32(r), _r_u32(r)
        return tp.StructuredArith(_deserialize_expr(r.read(_r_u32(r))), n, lvl)
    raise ValueError(kind)


def _w_ids(b, ids) -> None:
    _w_u32(b, len(ids))
    for i in ids:
        _w_u32(b, i)


def _r_ids(r) -> tuple:
    return tuple(_r_u32(r) for _ in range(_r_u32(r)))


def serialize(system: ConstraintSystem) -> bytes:
    b = io.BytesIO()
    b.write(MAGIC)
    _w_u32(b, len(system.oracles))
    for o in system.oracles.oracles:
        _w_str(b, o.variant)
        _w_u32(b, o.n_vars)
        _w_u32(b, o.tower_level)
        _w_ids(b, o.inner)
        _w_u32(b, o.shift_offset)
        _w_u32(b, o.shift_block_bits)
        _w_str(b, o.shift_variant)
        _w_u128(b, o.lc_offset)
        _w_u32(b, len(o.lc_coeffs))
        for c in o.lc_coeffs:
            _w_u128(b, c)
        _w_u32(b, o.log_degree)
        if o.variant == om.TRANSPARENT:
            _w_transparent(b, o.transparent)
        if o.variant == om.COMPOSITE:
            raw = _serialize_expr(o.composite)
            _w_u32(b, len(raw))
            b.write(raw)
        _w_str(b, o.name)
    _w_u32(b, len(system.constraint_sets))
    for cs in system.constraint_sets:
        _w_u32(b, cs.n_vars)
        _w_ids(b, cs.oracle_ids)
        _w_u32(b, len(cs.zero_constraints))
        for e in cs.zero_constraints:
            raw = _serialize_expr(e)
            _w_u32(b, len(raw))
            b.write(raw)
    _w_u32(b, len(system.flushes))
    for f in system.flushes:
        _w_u32(b, f.channel_id)
        _w_str(b, f.direction)
        _w_ids(b, f.oracle_ids)
        _w_u32(b, f.multiplicity)
        _w_ids(b, f.selector_ids)
    _w_u32(b, system.n_channels)
    _w_ids(b, [nz.oracle_id for nz in system.non_zero_claims])
    _w_u32(b, len(system.exponents))
    for e in system.exponents:
        _w_ids(b, e.bits_ids)
        _w_u32(b, e.exp_result_id)
        _w_u32(b, e.base_level)
        _w_i32(b, -1 if e.base_oracle is None else e.base_oracle)
        _w_u128(b, e.base_const if e.base_const is not None else 0)
    raw = b"" if system.symbolic is None else canonical.serialize(system.symbolic)
    _w_u32(b, len(raw))
    b.write(raw)
    return b.getvalue()


def _restore_projected(oracles: om.OracleSet, symbolic) -> None:
    """A projected oracle's bound values and start index, from its
    symbolic record ("projected", inner, values, ("offset", start))."""
    for oid, o in enumerate(oracles.oracles):
        if o.variant != om.PROJECTED or oid >= len(symbolic.oracles):
            continue
        v = symbolic.oracles[oid].variant
        assert v[0] == "projected" and v[1] == o.inner[0] and v[3][0] == "offset", v
        oracles.oracles[oid] = om.Oracle(**{**o.__dict__, "proj_values": tuple(v[2]),
                                            "start_index": v[3][1]})


def deserialize(data: bytes) -> ConstraintSystem:
    r = io.BytesIO(data)
    assert r.read(8) == MAGIC, "bad magic"
    oracles = om.OracleSet()
    for oid in range(_r_u32(r)):
        variant = _r_str(r)
        n_vars = _r_u32(r)
        level = _r_u32(r)
        inner = _r_ids(r)
        shift_offset = _r_u32(r)
        shift_block_bits = _r_u32(r)
        shift_variant = _r_str(r)
        lc_offset = _r_u128(r)
        lc_coeffs = tuple(_r_u128(r) for _ in range(_r_u32(r)))
        log_degree = _r_u32(r)
        transparent = _r_transparent(r) if variant == om.TRANSPARENT else None
        composite = (_deserialize_expr(r.read(_r_u32(r))) if variant == om.COMPOSITE
                     else None)
        oracles.oracles.append(om.Oracle(
            id=oid, n_vars=n_vars, tower_level=level, variant=variant, inner=inner,
            shift_offset=shift_offset, shift_block_bits=shift_block_bits,
            shift_variant=shift_variant, lc_offset=lc_offset, lc_coeffs=lc_coeffs,
            log_degree=log_degree, transparent=transparent, composite=composite,
            name=_r_str(r)))
    constraint_sets = []
    for _ in range(_r_u32(r)):
        n_vars = _r_u32(r)
        ids = _r_ids(r)
        exprs = tuple(_deserialize_expr(r.read(_r_u32(r))) for _ in range(_r_u32(r)))
        constraint_sets.append(ConstraintSet(n_vars, ids, exprs))
    flushes = []
    for _ in range(_r_u32(r)):
        channel = _r_u32(r)
        direction = _r_str(r)
        ids = _r_ids(r)
        mult = _r_u32(r)
        flushes.append(Flush(channel, direction, ids, mult, _r_ids(r)))
    n_channels = _r_u32(r)
    non_zero = [NonZeroClaim(i) for i in _r_ids(r)]
    exponents = []
    for _ in range(_r_u32(r)):
        bits_ids = _r_ids(r)
        result_id = _r_u32(r)
        base_level = _r_u32(r)
        base_oracle = _r_i32(r)
        base_const = _r_u128(r)
        exponents.append(Exp(bits_ids, result_id, base_level,
                             base_const=None if base_oracle >= 0 else base_const,
                             base_oracle=base_oracle if base_oracle >= 0 else None))
    n_canon = _r_u32(r)
    symbolic = canonical.deserialize(r.read(n_canon)) if n_canon else None
    if symbolic is not None:
        _restore_projected(oracles, symbolic)
    return ConstraintSystem(oracles, constraint_sets, flushes, n_channels, non_zero,
                            exponents, symbolic=symbolic)

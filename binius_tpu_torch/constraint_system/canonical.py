"""Reference-format (CanonicalTower) constraint-system serialization.

The port's copy of `binius_tpu/constraint_system/canonical.py`: the
writer and its reader (`deserialize`, which gives back the symbolic
system that `serialize` wrote). Byte-exact implementation of the
reference's `SerializeBytes` derive output
for `ConstraintSystem<BinaryField128b>` (`constraint_system/mod.rs:35-45`)
with `SerializationMode::CanonicalTower`:

  * primitives per `crates/utils/src/serialization.rs`: usize -> u32 LE,
    uN -> LE bytes, bool -> u8, String -> u32 len + UTF-8, Vec<T> -> u32 len
    + items, Option<T> -> bool + value, tuples -> fields in order;
  * enums: u8 variant index (declaration order) + fields
    (`crates/macros/src/lib.rs:41-44`);
  * OracleId -> u32 (`oracle/oracle_id.rs:35-43`);
  * field elements: canonical-tower value, 2^level/8 bytes LE
    (`binary_field.rs:771-801`, `underlier/small_uint.rs:246`);
  * ArithCircuit -> Vec<ArithCircuitStep> with steps in left-to-right
    postorder and the reference's Arc-POINTER dedup semantics emulated on
    object identity (`math/arith_expr.rs:700-761`, see `_expr_steps`);
    step variants Add=0 Mul=1 Pow=2 Const=3 Var=4 (`arith_expr.rs:200-206`);
  * transparent polynomials: registered type name + struct fields
    (`macros/src/lib.rs` erased_serialize_bytes, transparent/serialization.rs).

The serialized object is the SIZELESS symbolic system (oracles carry
table_id + log_values_per_row instead of n_vars, `oracle/symbolic.rs`), so
the digest is independent of the proven instance sizes, exactly as the
reference's `ConstraintSystem::digest::<Groestl256>()` (`mod.rs:51-57`).
The M3 builder records this symbolic form during `compile_sizes`; the
transcript observes `digest(symbolic)` in place of the legacy repr digest.

"""

from __future__ import annotations

import dataclasses
import functools
import io
import struct

from ..hash.groestl import groestl256
from ..math.arith import ArithExpr

# enum indices, declaration order in the reference
_VARIANTS = {
    "committed": 0, "transparent": 1, "structured": 2, "repeating": 3,
    "projected": 4, "shifted": 5, "packed": 6, "linear_combination": 7,
    "zero_padded": 8, "composite": 9,
}
_SHIFT_VARIANTS = {"circular_left": 0, "logical_left": 1, "logical_right": 2}
_SIZE_SPECS = {"arbitrary": 0, "po2": 1, "fixed": 2}
_DIRECTIONS = {"push": 0, "pull": 1}


# ---------------------------------------------------------------------------
# Symbolic (sizeless) records, written by m3.compile_sizes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SymbolicOracle:
    name: str | None
    table_id: int
    log_values_per_row: int
    tower_level: int
    variant: tuple  # tagged tuple, see serializer


@dataclasses.dataclass(frozen=True)
class SymbolicConstraint:
    name: str
    # ArithCircuit step tuple (see `circuit_steps`): the reference converts
    # ArithExpr -> ArithCircuit at assert_zero time (`table.rs:724-727`) and
    # every later transformation (var remapping) operates on the STEP LIST,
    # so the steps — including Arc-clone duplicates — are the canonical form.
    circuit: tuple
    predicate: tuple = ("zero",)  # ("sum", F) | ("zero",)


@dataclasses.dataclass(frozen=True)
class SymbolicConstraintSet:
    table_id: int
    log_values_per_row: int
    oracle_ids: tuple
    constraints: tuple  # SymbolicConstraint


@dataclasses.dataclass(frozen=True)
class SymbolicFlush:
    table_id: int
    log_values_per_row: int
    oracles: tuple  # ("oracle", id) | ("const", value, tower_level)
    channel_id: int
    direction: str
    selectors: tuple
    multiplicity: int


@dataclasses.dataclass(frozen=True)
class SymbolicExp:
    bits_ids: tuple
    base: tuple  # ("oracle", id) | ("const", value, tower_level)
    exp_result_id: int


@dataclasses.dataclass(frozen=True)
class SymbolicSystem:
    oracles: tuple          # SymbolicOracle, index = oracle id
    constraint_sets: tuple  # SymbolicConstraintSet
    non_zero_oracle_ids: tuple
    flushes: tuple          # SymbolicFlush
    exponents: tuple        # SymbolicExp
    channel_count: int
    table_size_specs: tuple  # ("arbitrary",) | ("po2",) | ("fixed", log)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class _W:
    def __init__(self):
        self.b = io.BytesIO()

    def u8(self, v):
        self.b.write(struct.pack("<B", v))

    def u32(self, v):
        self.b.write(struct.pack("<I", v))

    def u64(self, v):
        self.b.write(struct.pack("<Q", v))

    def f(self, v, level=7):
        """Canonical-tower field element: 2^level bits, min 1 byte, LE."""
        self.b.write(int(v).to_bytes(max(1, (1 << level) // 8), "little"))

    def string(self, s):
        raw = s.encode()
        self.u32(len(raw))
        self.b.write(raw)

    def option(self, v, write):
        if v is None:
            self.u8(0)
        else:
            self.u8(1)
            write(v)

    def vec(self, items, write):
        self.u32(len(items))
        for it in items:
            write(it)


def _expr_steps(expr: ArithExpr):
    """Left-to-right postorder with the reference's Arc-POINTER dedup
    semantics (`arith_expr.rs:700-761`) emulated on Python object identity.

    In the reference, an `Arc<ArithExpr>` is minted once per operator
    application (each operand value is wrapped fresh), and reusing an
    expression requires `.clone()` — which duplicates the TOP node but
    shares its children's Arcs. The circuit conversion memoizes on
    `Arc::as_ptr`, so: every syntactic operand use emits its own step for
    the operand's top node, while the operand's CHILDREN (the Arcs minted at
    its construction) dedup globally. Two structurally equal but separately
    constructed subtrees do NOT dedup (e.g. `(x+ci)*(y+ci)+ci` emits THREE
    Var(ci) steps).

    The Python analog: a node reused as an operand in several places plays
    the role of the Rust value that is cloned per use — its own step is
    re-emitted at every occurrence, while each (parent object, operand slot)
    pair identifies one construction-time Arc and is memoized globally.

    Because the conversion depends on object identity, it must run while the
    builder-constructed tree is still intact — callers convert at
    assert_zero/add_computed time (like the reference) and pass step tuples
    around from then on (`circuit_steps` / `remap_steps`)."""
    steps = []
    arc_memo: dict = {}  # (id(parent), slot) -> step index

    def emit(e) -> int:
        """Always append a fresh step for e's top node; children resolve
        through the construction-Arc memo."""
        if e.op == "const":
            step = ("const", int(e.value))
        elif e.op == "var":
            step = ("var", e.value)
        elif e.op in ("add", "mul", "pow"):
            child_idx = []
            for slot, a in enumerate(e.args):
                key = (id(e), slot)
                idx = arc_memo.get(key)
                if idx is None:
                    idx = emit(a)
                    arc_memo[key] = idx
                child_idx.append(idx)
            step = (("pow", child_idx[0], e.value) if e.op == "pow"
                    else (e.op, child_idx[0], child_idx[1]))
        else:
            raise ValueError(e.op)
        steps.append(step)
        return len(steps) - 1

    # the reference's top-level match never consults the memo for the root
    emit(expr)
    return steps


def circuit_steps(expr: ArithExpr) -> tuple:
    """ArithExpr tree -> ArithCircuit step tuple (Arc-model emission)."""
    return tuple(_expr_steps(expr))


def remap_steps(steps: tuple, mapping: dict) -> tuple:
    """Remap Var indices on a step tuple (the reference's
    `ArithCircuit::remap_vars`, which likewise operates on steps)."""
    return tuple(("var", mapping[s[1]]) if s[0] == "var" else s
                 for s in steps)


def _w_circuit(w: _W, circuit):
    steps = (circuit_steps(circuit) if isinstance(circuit, ArithExpr)
             else circuit)
    w.u32(len(steps))
    for st in steps:
        if st[0] == "add":
            w.u8(0)
            w.u32(st[1])
            w.u32(st[2])
        elif st[0] == "mul":
            w.u8(1)
            w.u32(st[1])
            w.u32(st[2])
        elif st[0] == "pow":
            w.u8(2)
            w.u32(st[1])
            w.u64(st[2])
        elif st[0] == "const":
            w.u8(3)
            w.f(st[1])
        else:  # var
            w.u8(4)
            w.u32(st[1])


def _w_transparent(w: _W, tname: str, payload: tuple):
    """erased_serialize: type-name string + struct fields in declared order.
    Payload is a tuple of (kind, value) tokens."""
    w.string(tname)
    for kind, v in payload:
        if kind == "usize":
            w.u32(v)
        elif kind == "u64":
            w.u64(v)
        elif kind == "f128":
            w.f(v)
        elif kind == "vec_f128":
            w.vec(v, w.f)
        else:
            raise ValueError(kind)


def _w_oracle_or_const(w: _W, entry: tuple):
    if entry[0] == "oracle":
        w.u8(0)
        w.u32(entry[1])
    else:
        w.u8(1)
        w.f(entry[1])
        w.u32(entry[2])


def _w_oracle(w: _W, o: SymbolicOracle, oid: int):
    w.u32(oid)
    w.option(o.name, w.string)
    w.u32(o.table_id)
    w.u32(o.log_values_per_row)
    w.u32(o.tower_level)
    v = o.variant
    w.u8(_VARIANTS[v[0]])
    if v[0] == "committed":
        pass
    elif v[0] == "transparent":
        _w_transparent(w, v[1], v[2])
    elif v[0] == "structured":
        _w_circuit(w, v[1])
    elif v[0] == "repeating":
        w.u32(v[1])
    elif v[0] == "projected":
        w.u32(v[1])
        w.vec(v[2], w.f)
        pv = v[3]
        if pv[0] == "offset":
            w.u8(0)
            w.u32(pv[1])
        else:
            w.u8(1)
    elif v[0] == "shifted":
        w.u32(v[1])
        w.u32(v[2])
        w.u32(v[3])
        w.u8(_SHIFT_VARIANTS[v[4]])
    elif v[0] == "packed":
        w.u32(v[1])
        w.u32(v[2])
    elif v[0] == "linear_combination":
        w.f(v[1])
        w.vec(v[2], lambda t: (w.u32(t[0]), w.f(t[1])))
    elif v[0] == "zero_padded":
        w.u32(v[1])
        w.u32(v[2])
        w.u32(v[3])
        w.u32(v[4])
    elif v[0] == "composite":
        w.vec(v[1], w.u32)
        _w_circuit(w, v[2])
    else:
        raise ValueError(v[0])


def serialize(sym: SymbolicSystem) -> bytes:
    w = _W()
    # oracles: SymbolicMultilinearOracleSet { oracles: Vec<...> }
    w.u32(len(sym.oracles))
    for oid, o in enumerate(sym.oracles):
        _w_oracle(w, o, oid)
    # table_constraints: Vec<ConstraintSet>
    def w_cs(cs: SymbolicConstraintSet):
        w.u32(cs.table_id)
        w.u32(cs.log_values_per_row)
        w.vec(cs.oracle_ids, w.u32)

        def w_c(c: SymbolicConstraint):
            w.string(c.name)
            _w_circuit(w, c.circuit)
            if c.predicate[0] == "sum":
                w.u8(0)
                w.f(c.predicate[1])
            else:
                w.u8(1)
        w.vec(cs.constraints, w_c)
    w.vec(sym.constraint_sets, w_cs)
    # non_zero_oracle_ids
    w.vec(sym.non_zero_oracle_ids, w.u32)
    # flushes
    def w_flush(f: SymbolicFlush):
        w.u32(f.table_id)
        w.u32(f.log_values_per_row)
        w.vec(f.oracles, lambda e: _w_oracle_or_const(w, e))
        w.u32(f.channel_id)
        w.u8(_DIRECTIONS[f.direction])
        w.vec(f.selectors, w.u32)
        w.u64(f.multiplicity)
    w.vec(sym.flushes, w_flush)
    # exponents
    def w_exp(e: SymbolicExp):
        w.vec(e.bits_ids, w.u32)
        _w_oracle_or_const(w, e.base)
        w.u32(e.exp_result_id)
    w.vec(sym.exponents, w_exp)
    # channel_count
    w.u32(sym.channel_count)
    # table_size_specs
    def w_spec(s):
        w.u8(_SIZE_SPECS[s[0]])
        if s[0] == "fixed":
            w.u32(s[1])
    w.vec(sym.table_size_specs, w_spec)
    return w.b.getvalue()


def digest(sym: SymbolicSystem) -> bytes:
    """`ConstraintSystem::digest::<Groestl256>()` (`mod.rs:51-57`)."""
    return _groestl256_memo(serialize(sym))


@functools.lru_cache(maxsize=16)
def _groestl256_memo(data: bytes) -> bytes:
    """Grøstl-256 of a serialization, remembered: the M3 verifier compiles
    the system anew from the proof's table sizes, and the host hash of
    keccak_lookups' 310 KB takes about a second."""
    return groestl256(data)


# ---------------------------------------------------------------------------
# Reader (round-trip of the symbolic form)
# ---------------------------------------------------------------------------

class _R:
    def __init__(self, data: bytes):
        self.b = io.BytesIO(data)

    def u8(self):
        return struct.unpack("<B", self.b.read(1))[0]

    def u32(self):
        return struct.unpack("<I", self.b.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.b.read(8))[0]

    def f(self, level=7):
        return int.from_bytes(self.b.read(max(1, (1 << level) // 8)), "little")

    def string(self):
        return self.b.read(self.u32()).decode()

    def option(self, read):
        return read() if self.u8() else None

    def vec(self, read):
        return tuple(read() for _ in range(self.u32()))


def _r_circuit(r: _R) -> tuple:
    """An ArithCircuit read back as its step tuple, the canonical form (a
    tree would lose the duplicated steps of reused subexpressions)."""
    n = r.u32()
    steps = []
    for _ in range(n):
        tag = r.u8()
        if tag == 0:
            steps.append(("add", r.u32(), r.u32()))
        elif tag == 1:
            steps.append(("mul", r.u32(), r.u32()))
        elif tag == 2:
            steps.append(("pow", r.u32(), r.u64()))
        elif tag == 3:
            steps.append(("const", r.f()))
        elif tag == 4:
            steps.append(("var", r.u32()))
        else:
            raise ValueError(tag)
    return tuple(steps)


_TRANSPARENT_FIELDS = {
    # registered name -> field token kinds, declared order
    "Constant": ("usize", "f128", "usize"),
    "StepDown": ("usize", "usize"),
    "StepUp": ("usize", "usize"),
    "MultilinearExtensionTransparent": ("vec_f128",),
}


def _r_transparent(r: _R):
    tname = r.string()
    kinds = _TRANSPARENT_FIELDS[tname]
    payload = []
    for kind in kinds:
        if kind == "usize":
            payload.append((kind, r.u32()))
        elif kind == "u64":
            payload.append((kind, r.u64()))
        elif kind == "f128":
            payload.append((kind, r.f()))
        elif kind == "vec_f128":
            payload.append((kind, r.vec(r.f)))
    return tname, tuple(payload)


def deserialize(data: bytes) -> SymbolicSystem:
    r = _R(data)
    inv_var = {v: k for k, v in _VARIANTS.items()}
    inv_shift = {v: k for k, v in _SHIFT_VARIANTS.items()}
    inv_spec = {v: k for k, v in _SIZE_SPECS.items()}
    inv_dir = {v: k for k, v in _DIRECTIONS.items()}

    def r_oracle():
        r.u32()  # id (dense, implied by position)
        name = r.option(r.string)
        table_id = r.u32()
        vpr = r.u32()
        lvl = r.u32()
        tag = inv_var[r.u8()]
        if tag == "committed":
            variant = ("committed",)
        elif tag == "transparent":
            tname, payload = _r_transparent(r)
            variant = ("transparent", tname, payload)
        elif tag == "structured":
            variant = ("structured", _r_circuit(r))
        elif tag == "repeating":
            variant = ("repeating", r.u32())
        elif tag == "projected":
            oid = r.u32()
            vals = r.vec(r.f)
            pv = ("offset", r.u32()) if r.u8() == 0 else ("last",)
            variant = ("projected", oid, vals, pv)
        elif tag == "shifted":
            variant = ("shifted", r.u32(), r.u32(), r.u32(),
                       inv_shift[r.u8()])
        elif tag == "packed":
            variant = ("packed", r.u32(), r.u32())
        elif tag == "linear_combination":
            off = r.f()
            inner = r.vec(lambda: (r.u32(), r.f()))
            variant = ("linear_combination", off, inner)
        elif tag == "zero_padded":
            variant = ("zero_padded", r.u32(), r.u32(), r.u32(), r.u32())
        else:
            variant = ("composite", r.vec(r.u32), _r_circuit(r))
        return SymbolicOracle(name, table_id, vpr, lvl, variant)

    def r_oracle_or_const():
        if r.u8() == 0:
            return ("oracle", r.u32())
        return ("const", r.f(), r.u32())

    oracles = r.vec(r_oracle)

    def r_cs():
        table_id, vpr = r.u32(), r.u32()
        ids = r.vec(r.u32)

        def r_c():
            name = r.string()
            expr = _r_circuit(r)
            pred = ("sum", r.f()) if r.u8() == 0 else ("zero",)
            return SymbolicConstraint(name, expr, pred)
        return SymbolicConstraintSet(table_id, vpr, ids, r.vec(r_c))

    constraint_sets = r.vec(r_cs)
    non_zero = r.vec(r.u32)

    def r_flush():
        table_id, vpr = r.u32(), r.u32()
        entries = r.vec(r_oracle_or_const)
        ch = r.u32()
        d = inv_dir[r.u8()]
        sels = r.vec(r.u32)
        mult = r.u64()
        return SymbolicFlush(table_id, vpr, entries, ch, d, sels, mult)

    flushes = r.vec(r_flush)

    def r_exp():
        bits = r.vec(r.u32)
        base = r_oracle_or_const()
        return SymbolicExp(bits, base, r.u32())

    exps = r.vec(r_exp)
    channel_count = r.u32()

    def r_spec():
        tag = inv_spec[r.u8()]
        return (tag, r.u32()) if tag == "fixed" else (tag,)

    specs = r.vec(r_spec)
    assert not r.b.read(1), "trailing bytes"
    return SymbolicSystem(oracles, constraint_sets, non_zero, flushes, exps,
                          channel_count, specs)

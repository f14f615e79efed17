"""Print the JAX package's proof digest for a seeded instance of a circuit.

The H100 port's `chip_smoke.py` and its tests hold these digests as golden
constants: the port's `constraint_system.prove`, on its kernel path and on
its plain path, must reproduce each proof byte for byte. Each instance is
built with the JAX package alone, on the CPU, the way the examples build
it, from inputs drawn here with the same generators as the port's
instance helpers:

- `u32_add`: one u32_add table of 2^size rows (`U32Add.build`), x and y
  the 2^size u32 pairs of numpy's `default_rng(seed)` (x, then y), as
  `binius_tpu_torch.m3.gadgets.arith.u32_add_rows` draws them;
- `b32_mul`: `examples/b32_mul.py`'s hand-built system of 2^size B32
  products A*B + C, a and b drawn from `default_rng(seed)` (a, then b), as
  `binius_tpu_torch.m3.gadgets.b32_mul.b32_mul_inputs` draws them;
- `keccak`: `examples/keccak.py`'s table of 2^size Keccak-f[1600]
  permutations, 25 lanes per row from `random.Random(seed).getrandbits(64)`
  (`binius_tpu_torch.m3.gadgets.keccak.keccak_inputs`);
- `groestl`: `examples/groestl.py`'s table of 2^size Grøstl P
  permutations, 64 state bytes per row, row-major, from
  `random.Random(seed).getrandbits(8)`
  (`binius_tpu_torch.m3.gadgets.groestl.groestl_inputs`);
- `u32_mul_gkr`: `examples/u32_mul_gkr.py`'s table of 2^size u32
  products through the GKR exponentiation phase (`MulUU32`), x then y
  from `random.seed(seed)`, each `random.getrandbits(32)`
  (`binius_tpu_torch.m3.gadgets.mul.mul_inputs`);
- `bitwise_ops`: `examples/bitwise_ops.py`'s table of 2^size rows of u32
  AND, XOR and OR, x then y from `default_rng(seed)`
  (`binius_tpu_torch.m3.gadgets.arith.bitwise_rows`);
- `keccak_lookups`: `examples/keccak_lookups.py`'s system
  (`KeccakLookedupCS`: 2^size Keccak-f permutations with chi through the
  bit-AND lookup channel, and the 4-row lookup table), 25 lanes per row
  from `random.seed(seed)`, each `random.getrandbits(64)`, table sizes
  [2^size, 4] as the proof's first message
  (`binius_tpu_torch.m3.gadgets.keccak.keccak_lookups_system`);
- the channel systems of `tests/test_channels.py` and `tests/test_lookup.py`
  on 2^size rows of B32 columns drawn from `random.Random(seed)`
  (`binius_tpu_torch.circuits.channel_system` draws them alike):
  `perm_channel` (a pushed, its shuffle b pulled), `boundary` (a pulled,
  its values pushed as boundaries), `selector_flush` (a selected push
  and a selected pull), `lookup_flush` (a table pushed with multiplicity
  bits 1 and 2 as selectors, the reads pulled) and `nonzero` (a
  non-zero claim on an odd column);
- `sha256`: `examples/sha256.py`'s table of 2^size SHA-256 compressions,
  16 message words per row from `random.seed(seed)`, each
  `random.getrandbits(32)`
  (`binius_tpu_torch.m3.gadgets.sha256.sha256_inputs`);
- `merkle_tree`: `examples/merkle_tree.py`'s inclusion proof of
  `MERKLE_OPENED[size]` opened leaves in a tree of 2^size leaves (root id
  7), the leaves' bytes then the opened indices drawn after
  `random.seed(seed)` (`binius_tpu_torch.m3.gadgets.merkle_tree.merkle_inputs`),
  with its boundaries and table sizes;
- `u32_sub`: one table ("u32sub") of 2^size u32 subtractions
  (`U32Sub.build(t, "sub", xin, yin)`), x then y the 2^size u32 values of
  numpy's `default_rng(seed)`, each `integers(0, 2**32, 2**size)`;
- `u32_mul`: one table ("mul") of 2^size schoolbook u32 products
  (`U32Mul.build(t, "mul", xin, yin)`), x then y drawn as u32_sub's;
- `barrel_shifter`: one table ("barrel_shifter") of one u32 column xin
  and its three barrel shifters `rotl` (CIRCULAR_LEFT), `shl`
  (LOGICAL_LEFT) and `shr` (LOGICAL_RIGHT); from numpy's
  `default_rng(seed)`: x (`integers(0, 2**32, 2**size)`), then the
  amounts of rotl, shl and shr (each `integers(0, 32, 2**size)`);
- `div_uu32`: one table ("div") of 2^size u32 divisions
  (`DivUU32.build(t, "div")`); from numpy's `default_rng(seed)`: the
  dividends p (`integers(0, 2**32, 2**size)`), then the divisors q
  (`integers(0, 2**16, 2**size) + 1`);
- `golden_8`: the golden 8-row u32_add proof of
  `tests/test_golden_transcript.py` (rows from `random.Random(42)`);
- `grouped_lookup_exp`: `m3.instances.grouped_lookup_exp_instance(seed)`
  (indexed lookups, a MulUU32 exponentiation and two same-structure u32_add
  tables; its size is fixed, pass `--seed 17`, the instance's default);
- `grouped_zerocheck`: no proof of a system but the univariate-skip
  zerocheck transcript alone (`univariate_zerocheck.batch_prove`, ungrouped)
  of `tests/test_univariate_zerocheck.py`'s grouped claims at 2^size rows:
  three claims out + a*b (out = a AND b) and one out + a*a of B1 columns,
  bits from `random.Random(7).randrange(2)` (out, a, b per claim in turn);
  it prints the skip, the transcript's length and its sha256.

The proof is `constraint_system.prove.prove(core, witness, log_inv_rate=1)`
(with the boundaries or the table sizes where the instance has them),
checked with the JAX verifier:

    python scripts/port_golden_proof.py [--circuit u32_add ...] [--size 16] [--seed 0]

For each circuit named it prints the system digest and the sha256 of its
`constraint_system.serialization.serialize` bytes, then the proof's
length and sha256 and its bytes per phase (`last_phase_sizes`; minutes on
a CPU, most of it compiling; the circuits named together share one
process's compiled functions). `--systems-only` prints the first line
alone and proves nothing.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import sys

# the size each circuit's golden digest is pinned at
DEFAULT_SIZE = {"u32_add": 16, "b32_mul": 10, "keccak": 1, "groestl": 3,
                "u32_mul_gkr": 7, "bitwise_ops": 5, "keccak_lookups": 0,
                "perm_channel": 3, "boundary": 2, "selector_flush": 3, "lookup_flush": 3,
                "nonzero": 3, "sha256": 0, "merkle_tree": 4, "u32_sub": 4, "u32_mul": 2,
                "barrel_shifter": 2, "div_uu32": 2, "golden_8": 3,
                "grouped_lookup_exp": 0, "grouped_zerocheck": 6}
# merkle_tree: the opened leaves of the instance of 2^size leaves
MERKLE_OPENED = {4: 3, 6: 8}
CHANNEL_SYSTEMS = ("perm_channel", "boundary", "selector_flush", "lookup_flush", "nonzero")


def channel_system(name: str, size: int, seed: int):
    """(core system, witness, statement keywords) of a hand-built channel
    system of the JAX package on 2^size rows, its B32 values drawn from
    `random.Random(seed)` in the order written here."""
    from binius_tpu.constraint_system import oracle as om
    from binius_tpu.constraint_system.system import (Boundary, ConstraintSystem, Flush,
                                                     NonZeroClaim, PULL, PUSH)
    from binius_tpu.fields import tower

    rng = random.Random(seed)
    n = 1 << size
    oracles = om.OracleSet()
    cols, kw = {}, {}

    def commit(nm, vals):
        cols[oracles.add_committed(size, 5, nm)] = vals

    if name == "perm_channel":
        a = [rng.getrandbits(32) for _ in range(n)]
        b = list(a)
        rng.shuffle(b)
        commit("a", a)
        commit("b", b)
        system = ConstraintSystem(oracles, [], flushes=[Flush(0, PUSH, (0,)),
                                                        Flush(0, PULL, (1,))], n_channels=1)
    elif name == "boundary":
        a = [rng.getrandbits(32) for _ in range(n)]
        commit("a", a)
        system = ConstraintSystem(oracles, [], flushes=[Flush(0, PULL, (0,))], n_channels=1)
        kw["boundaries"] = [Boundary(0, PUSH, (v,)) for v in a]
    elif name == "selector_flush":
        a = [rng.getrandbits(32) for _ in range(n)]
        sel = [(0b01001101 >> (r % 8)) & 1 for r in range(n)]
        picked = [v for v, s in zip(a, sel) if s]
        b = picked + [rng.getrandbits(32) for _ in range(n - len(picked))]
        commit("a", a)
        commit("sel", sel)
        commit("b", b)
        commit("sel_b", [1] * len(picked) + [0] * (n - len(picked)))
        system = ConstraintSystem(oracles, [], flushes=[
            Flush(0, PUSH, (0,), selector_ids=(1,)),
            Flush(0, PULL, (2,), selector_ids=(3,))], n_channels=1)
    elif name == "lookup_flush":
        table_val = [(i * i) & 0xFF for i in range(n)]
        while True:
            reads = [rng.randrange(n) for _ in range(n)]
            counts = [reads.count(i) for i in range(n)]
            if max(counts) < 4:
                break
        commit("t_idx", list(range(n)))
        commit("t_val", table_val)
        commit("r_idx", reads)
        commit("r_val", [table_val[i] for i in reads])
        commit("m0", [c & 1 for c in counts])
        commit("m1", [c >> 1 for c in counts])
        system = ConstraintSystem(oracles, [], flushes=[
            Flush(0, PUSH, (0, 1), multiplicity=1, selector_ids=(4,)),
            Flush(0, PUSH, (0, 1), multiplicity=2, selector_ids=(5,)),
            Flush(0, PULL, (2, 3))], n_channels=1)
    elif name == "nonzero":
        commit("a", [rng.getrandbits(32) | 1 for _ in range(n)])
        system = ConstraintSystem(oracles, [], non_zero_claims=[NonZeroClaim(0)])
    else:
        raise ValueError(name)
    return system, {oid: (5, tower.from_ints(5, v)) for oid, v in cols.items()}, kw


def keccak_lookups(size: int, seed: int):
    """(core system, witness, statement keywords) of examples/keccak_lookups.py's
    system at 2^size permutations."""
    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.builder.witness import WitnessIndex
    from binius_tpu.m3.gadgets.keccak import KeccakLookedupCS

    random.seed(seed)
    n = 1 << size
    m3 = M3ConstraintSystem()
    cs = KeccakLookedupCS.build(m3, size)
    sizes = cs.table_sizes(n)
    core, omap = m3.compile_sizes(sizes)
    wi = WitnessIndex.with_sizes(m3, sizes)
    cs.populate(wi, [[random.getrandbits(64) for _ in range(25)] for _ in range(n)])
    return core, wi.to_core_witness(core, omap), {"table_sizes": sizes}


def sha256(size: int, seed: int):
    """(core system, witness) of examples/sha256.py's table at 2^size
    compressions."""
    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.builder.witness import WitnessIndex
    from binius_tpu.m3.gadgets.sha256 import Sha256

    random.seed(seed)
    n = 1 << size
    m3 = M3ConstraintSystem()
    t = m3.add_table("sha256")
    msg = [t.add_committed(f"m{i}", 0, 5) for i in range(16)]
    gadget = Sha256.build(t, "sha", msg)
    core, omap = m3.compile([size])
    wi = WitnessIndex(m3, [size])
    tw = wi.table(0)
    rows = [[random.getrandbits(32) for _ in range(16)] for _ in range(n)]
    for i, col in enumerate(msg):
        tw.set_packed_ints(col, [r[i] for r in rows])
    gadget.populate(tw, rows)
    return core, wi.to_core_witness(core, omap)


def merkle_tree(size: int, seed: int):
    """(core system, witness, statement keywords) of examples/merkle_tree.py's
    system: MERKLE_OPENED[size] inclusions in a tree of 2^size leaves."""
    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.builder.witness import WitnessIndex
    from binius_tpu.m3.gadgets.merkle_tree import MerkleTreeCS, MerkleTreeTrace

    random.seed(seed)
    n = 1 << size
    leaves = [bytes(random.getrandbits(8) for _ in range(32)) for _ in range(n)]
    opened = random.sample(range(n), MERKLE_OPENED[size])
    trace = MerkleTreeTrace.generate(7, leaves, opened)
    m3 = M3ConstraintSystem()
    cs = MerkleTreeCS(m3)
    sizes = cs.table_sizes(trace)
    core, omap = m3.compile_sizes(sizes)
    wi = WitnessIndex.with_sizes(m3, sizes)
    cs.fill_tables(trace, wi)
    return (core, wi.to_core_witness(core, omap),
            {"boundaries": cs.make_boundaries(trace), "table_sizes": sizes})


def golden_8():
    """(core system, witness) of tests/test_golden_transcript.py's golden
    8-row u32_add instance."""
    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.builder.witness import WitnessIndex
    from binius_tpu.m3.gadgets import arith

    rng = random.Random(42)
    xs = [rng.getrandbits(32) for _ in range(8)]
    ys = [rng.getrandbits(32) for _ in range(8)]
    m3 = M3ConstraintSystem()
    t = m3.add_table("u32add")
    xin = t.add_committed("xin", 0, arith.LOG_U32)
    yin = t.add_committed("yin", 0, arith.LOG_U32)
    adder = arith.U32Add.build(t, "add", xin, yin)
    core, omap = m3.compile([3])
    wi = WitnessIndex(m3, [3])
    tw = wi.table(0)
    tw.set_packed_ints(xin, xs)
    tw.set_packed_ints(yin, ys)
    adder.populate(tw, xs, ys)
    return core, wi.to_core_witness(core, omap)


def gadget_table(circuit: str):
    """(M3 system, fill) of the u32_sub, u32_mul, barrel_shifter or
    div_uu32 table: fill(table witness, rng, n) draws n rows of inputs from
    the numpy generator rng, as the module docstring says, and fills the
    table's committed columns."""
    import numpy as np

    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.gadgets import arith, barrel_shifter, div, mul

    def u32s(rng, n, bound=1 << 32):
        return [int(v) for v in rng.integers(0, bound, n, dtype=np.uint64)]

    m3 = M3ConstraintSystem()
    if circuit in ("u32_sub", "u32_mul"):
        t = m3.add_table("u32sub" if circuit == "u32_sub" else "mul")
        xin = t.add_committed("xin", 0, arith.LOG_U32)
        yin = t.add_committed("yin", 0, arith.LOG_U32)
        gadget = (arith.U32Sub.build(t, "sub", xin, yin) if circuit == "u32_sub"
                  else mul.U32Mul.build(t, "mul", xin, yin))

        def fill(tw, rng, n):
            x, y = u32s(rng, n), u32s(rng, n)
            tw.set_packed_ints(xin, x)
            tw.set_packed_ints(yin, y)
            gadget.populate(tw, x, y)
    elif circuit == "barrel_shifter":
        kinds = (("rotl", barrel_shifter.CIRCULAR_LEFT), ("shl", barrel_shifter.LOGICAL_LEFT),
                 ("shr", barrel_shifter.LOGICAL_RIGHT))
        t = m3.add_table("barrel_shifter")
        xin = t.add_committed("xin", 0, arith.LOG_U32)
        gadgets = [barrel_shifter.BarrelShifter.build(t, name, xin, kind) for name, kind in kinds]

        def fill(tw, rng, n):
            x = u32s(rng, n)
            amounts = [u32s(rng, n, 32) for _ in kinds]
            tw.set_packed_ints(xin, x)
            for g, (_, kind), a in zip(gadgets, kinds, amounts):
                g.populate(tw, x, a, kind)
    elif circuit == "div_uu32":
        gadget = div.DivUU32.build(m3.add_table("div"), "div")

        def fill(tw, rng, n):
            p = u32s(rng, n)
            gadget.populate(tw, p, [q + 1 for q in u32s(rng, n, 1 << 16)])
    else:
        raise ValueError(circuit)
    return m3, fill


def gadget_circuit(circuit: str, size: int, seed: int):
    """(core system, witness) of `gadget_table(circuit)` at 2^size rows,
    its inputs drawn from numpy's `default_rng(seed)`."""
    import numpy as np

    from binius_tpu.m3.builder.witness import WitnessIndex

    m3, fill = gadget_table(circuit)
    core, omap = m3.compile([size])
    wi = WitnessIndex(m3, [size])
    fill(wi.table(0), np.random.default_rng(seed), 1 << size)
    return core, wi.to_core_witness(core, omap)


def statement(circuit: str, size: int, seed: int):
    """(core system, witness, keywords of `prove` and `verify`) of one
    instance: the boundaries or the table sizes where it has them."""
    if circuit == "golden_8":
        return (*golden_8(), {})
    if circuit == "grouped_lookup_exp":
        from binius_tpu.m3.instances import grouped_lookup_exp_instance
        return (*grouped_lookup_exp_instance(seed), {})
    if circuit in ("u32_sub", "u32_mul", "barrel_shifter", "div_uu32"):
        return (*gadget_circuit(circuit, size, seed), {})
    if circuit in CHANNEL_SYSTEMS:
        return channel_system(circuit, size, seed)
    if circuit == "keccak_lookups":
        return keccak_lookups(size, seed)
    if circuit == "merkle_tree":
        return merkle_tree(size, seed)
    if circuit == "sha256":
        return (*sha256(size, seed), {})
    return (*build(circuit, size, seed), {})


def build(circuit: str, size: int, seed: int, variant: str = "P"):
    """(core system, witness) of the JAX package for one instance; the
    port's tests hold the port's builders against it. `variant` picks
    groestl's P or Q permutation (the table `groestl_p` or `groestl_q`)."""
    import numpy as np

    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.m3.builder.witness import WitnessIndex

    n = 1 << size
    if circuit == "u32_add":
        from binius_tpu.m3.gadgets import arith
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        y = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        m3 = M3ConstraintSystem()
        t = m3.add_table("u32add")
        xin = t.add_committed("xin", 0, arith.LOG_U32)
        yin = t.add_committed("yin", 0, arith.LOG_U32)
        adder = arith.U32Add.build(t, "add", xin, yin)
        core, omap = m3.compile([size])
        wi = WitnessIndex(m3, [size])
        tw = wi.table(0)
        tw.set_packed_ints(xin, x)
        tw.set_packed_ints(yin, y)
        adder.populate(tw, x, y)
        return core, wi.to_core_witness(core, omap)
    if circuit == "b32_mul":
        from binius_tpu.constraint_system import oracle as om
        from binius_tpu.constraint_system.system import ConstraintSet, ConstraintSystem
        from binius_tpu.fields import tower
        from binius_tpu.math.arith import ArithExpr
        rng = np.random.default_rng(seed)
        a_np = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        b_np = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        oracles = om.OracleSet()
        a_id = oracles.add_committed(size, 5, "a")
        b_id = oracles.add_committed(size, 5, "b")
        c_id = oracles.add_committed(size, 5, "c")
        A, B, C = (ArithExpr.var(i) for i in range(3))
        core = ConstraintSystem(oracles, [ConstraintSet(size, (a_id, b_id, c_id), (A * B + C,))])
        a, b = tower.from_numpy(5, a_np), tower.from_numpy(5, b_np)
        return core, {a_id: (5, a), b_id: (5, b), c_id: (5, tower.mul(5, a, b))}
    if circuit == "bitwise_ops":
        from binius_tpu.m3.gadgets import arith
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
        y = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
        m3 = M3ConstraintSystem()
        t = m3.add_table("bitwise")
        xin = t.add_committed("xin", 0, arith.LOG_U32)
        yin = t.add_committed("yin", 0, arith.LOG_U32)
        outs = [arith.u32_bitwise_and(t, "and", xin, yin),
                arith.u32_bitwise_xor(t, "xor", xin, yin),
                arith.u32_bitwise_or(t, "or", xin, yin)]
        core, omap = m3.compile([size])
        wi = WitnessIndex(m3, [size])
        tw = wi.table(0)
        for col, vals in zip((xin, yin, *outs), (x, y, x & y, x ^ y, x | y)):
            tw.set_packed_ints(col, vals)
        return core, wi.to_core_witness(core, omap)
    if circuit == "u32_mul_gkr":
        from binius_tpu.m3.gadgets.mul import MulUU32
        random.seed(seed)
        xs = [random.getrandbits(32) for _ in range(n)]
        ys = [random.getrandbits(32) for _ in range(n)]
        m3 = M3ConstraintSystem()
        t = m3.add_table("mul")
        gadget = MulUU32.build(t, "mul")
        core, omap = m3.compile([size])
        wi = WitnessIndex(m3, [size])
        gadget.populate(wi.table(0), xs, ys)
        return core, wi.to_core_witness(core, omap)
    rng = random.Random(seed)
    m3 = M3ConstraintSystem()
    if circuit == "keccak":
        from binius_tpu.m3.gadgets.keccak import KeccakF
        t = m3.add_table("keccak")
        state_in = [t.add_committed(f"in{i}", 0, 6) for i in range(25)]
        gadget = KeccakF.build(t, "kf", state_in)
        rows = [[rng.getrandbits(64) for _ in range(25)] for _ in range(n)]
    elif circuit == "groestl":
        from binius_tpu.m3.gadgets.groestl import Permutation
        t = m3.add_table(f"groestl_{variant.lower()}")
        gadget = Permutation.build(t, "perm", variant)
        rows = [np.array([[rng.getrandbits(8) for _ in range(8)] for _ in range(8)],
                         dtype=np.uint8) for _ in range(n)]
    else:
        raise ValueError(circuit)
    core, omap = m3.compile([size])
    wi = WitnessIndex(m3, [size])
    gadget.populate(wi.table(0), rows)
    return core, wi.to_core_witness(core, omap)


def grouped_zerocheck(size: int):
    """(claims, multilinears) of the grouped zerocheck at 2^size rows."""
    from binius_tpu.fields import tower
    from binius_tpu.math.arith import ArithExpr, CompositionPoly
    from binius_tpu.protocols.sumcheck.zerocheck import ZerocheckClaim

    V = ArithExpr.var
    rng = random.Random(7)
    claims, mls = [], []
    for _ in range(3):
        a = [rng.randrange(2) for _ in range(1 << size)]
        b = [rng.randrange(2) for _ in range(1 << size)]
        out = [x & y for x, y in zip(a, b)]
        claims.append(ZerocheckClaim(size, 3, (CompositionPoly(V(0) + V(1) * V(2), 3),)))
        mls.append([(0, tower.from_ints(0, v)) for v in (out, a, b)])
    a = [rng.randrange(2) for _ in range(1 << size)]
    claims.append(ZerocheckClaim(size, 2, (CompositionPoly(V(0) + V(1) * V(1), 2),)))
    mls.append([(0, tower.from_ints(0, a)), (0, tower.from_ints(0, a))])
    return claims, mls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--circuit", choices=sorted(DEFAULT_SIZE), nargs="+", default=["u32_add"])
    ap.add_argument("--size", "--log-rows", type=int, default=None,
                    help="log2 of the rows, products or permutations")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--systems-only", action="store_true",
                    help="print each system's digest and serialization sha256, prove nothing")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from binius_tpu.constraint_system import prove as csp
    from binius_tpu.constraint_system import serialization

    for circuit in args.circuit:
        size = DEFAULT_SIZE[circuit] if args.size is None else args.size
        if circuit == "grouped_zerocheck":
            from binius_tpu.protocols.sumcheck import univariate_zerocheck as uzc
            from binius_tpu.transcript.transcript import ProverTranscript
            claims, mls = grouped_zerocheck(size)
            skip = uzc.compute_skip_rounds(claims)
            pt = ProverTranscript()
            uzc.batch_prove(claims, mls, pt, skip, group_claims=False)
            tape = pt.finalize()
            print(circuit, size, "skip", skip, len(tape), hashlib.sha256(tape).hexdigest(),
                  flush=True)
            continue
        core, witness, kw = statement(circuit, size, args.seed)
        wire = hashlib.sha256(serialization.serialize(core)).hexdigest()
        print(circuit, size, "digest", core.digest().hex(), "serialize", wire, flush=True)
        if args.systems_only:
            continue
        proof = csp.prove(core, witness, log_inv_rate=1, **kw)
        sizes = dict(csp.last_phase_sizes)
        csp.verify(core, proof, log_inv_rate=1, **kw)
        print(circuit, size, len(proof), hashlib.sha256(proof).hexdigest(), flush=True)
        print(circuit, size, "phase sizes", json.dumps(sizes), flush=True)


if __name__ == "__main__":
    main()

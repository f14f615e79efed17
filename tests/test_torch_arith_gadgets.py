"""The port's U32Sub, U32Mul, BarrelShifter, WideAdd / WideSub and DivUU32
gadgets on the CPU against the JAX package's.

Each table is built by both packages from the same seeded inputs at the
size of the JAX package's own test of the gadget (`tests/test_m3.py`,
`test_mul_gadget.py`, `test_barrel_shifter.py`, `test_div_gadget.py`;
u32_sub at its golden 2^4 rows):
the system digests and every witness column (through `convert.py`) are
compared byte for byte, and `validate_witness` accepts the port's. The
five bad witnesses of those tests are rejected by the port. The four
circuits at their golden sizes (`chip_smoke.GOLDEN_CIRCUITS`: u32_sub
2^4, u32_mul, barrel_shifter and div_uu32 2^2, seed 0) give the JAX
package's proof length and sha256 (pinned from
`scripts/port_golden_proof.py --circuit`; the JAX prover is not run
here), and the JAX verifier accepts the port's div_uu32 proof, the one
through the exponentiation phase and a non-zero claim. Exact comparisons
throughout."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from scripts import port_golden_proof
from binius_tpu_torch import circuits
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system.system import validate_witness
from binius_tpu_torch.convert import to_reference
from binius_tpu_torch.m3.builder.table import M3ConstraintSystem
from binius_tpu_torch.m3.builder.witness import WitnessIndex
from binius_tpu_torch.m3.gadgets import barrel_shifter as bs
from binius_tpu_torch.m3.gadgets.div import DivUU32, WideAdd, WideSub
from binius_tpu_torch.m3.gadgets.mul import MulUU32, U32Mul

torch.set_num_threads(1)  # the suite's test processes share the cores

GADGETS = ("u32_sub", "u32_mul", "barrel_shifter", "div_uu32")
M32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def built():
    """circuit -> (port instance, JAX system and witness) at the golden
    size, which is the size of each gadget's JAX test (u32_sub's 2^4 for
    its 2^2), built once."""
    cache = {}

    def get(circuit):
        if circuit not in cache:
            size = chip_smoke.GOLDEN_CIRCUITS[circuit][0]
            cache[circuit] = (circuits.instance(circuit, size, 0, "cpu")[:2],
                              port_golden_proof.gadget_circuit(circuit, size, 0))
        return cache[circuit]
    return get


def _assert_witness_equal(ours: dict, theirs: dict) -> None:
    assert sorted(ours) == sorted(int(k) for k in theirs)
    for oid, (lvl, d) in ours.items():
        jl, jd = theirs[oid]
        assert lvl == jl, oid
        assert np.array_equal(to_reference(d), np.asarray(jd).view(np.uint32)), oid


@pytest.mark.parametrize("circuit", GADGETS)
def test_gadget_witness_equals_reference(built, circuit):
    (core, witness), (jcore, jwitness) = built(circuit)
    assert core.digest() == jcore.digest()
    assert [(o.variant, o.n_vars, o.tower_level, o.name) for o in core.oracles.oracles] == \
        [(o.variant, o.n_vars, o.tower_level, o.name) for o in jcore.oracles.oracles]
    _assert_witness_equal(witness, jwitness)
    validate_witness(core, dict(witness))


def _wide_table(pkg):
    """`tests/test_div_gadget.py::test_wide_add_sub`'s table in the package
    `pkg` ("port" or "jax"): 8 bit columns each of x and y, their WideAdd
    and WideSub, 8 rows of 8-bit values from numpy's `default_rng(3)`."""
    if pkg == "jax":
        from binius_tpu.m3.builder.table import M3ConstraintSystem as M3
        from binius_tpu.m3.builder.witness import WitnessIndex as WI
        from binius_tpu.m3.gadgets.div import WideAdd as Add, WideSub as Sub
    else:
        M3, WI, Add, Sub = M3ConstraintSystem, WitnessIndex, WideAdd, WideSub
    rng = np.random.default_rng(3)
    xs = [int(v) for v in rng.integers(0, 256, 8)]
    ys = [int(v) for v in rng.integers(0, 256, 8)]
    m3 = M3()
    t = m3.add_table("wide")
    xb = [t.add_committed(f"x{i}", 0, 0) for i in range(8)]
    yb = [t.add_committed(f"y{i}", 0, 0) for i in range(8)]
    add = Add.build(t, "add", xb, yb)
    sub = Sub.build(t, "sub", xb, yb)
    core, omap = m3.compile([3])
    wi = WI(m3, [3])
    tw = wi.table(0)
    for i in range(8):
        tw.set_column(xb[i], [(v >> i) & 1 for v in xs])
        tw.set_column(yb[i], [(v >> i) & 1 for v in ys])
    zs = [int(z) for z in add.populate(tw, xs, ys)]
    ds = [int(d) for d in sub.populate(tw, xs, ys)]
    assert zs == [(x + y) & 0xFF for x, y in zip(xs, ys)]
    assert ds == [(x - y) & 0xFF for x, y in zip(xs, ys)]
    if pkg == "jax":
        return core, wi.to_core_witness(core, omap)
    return core, wi.to_core_witness(core, omap, "cpu")


def test_wide_add_sub_equals_reference():
    core, witness = _wide_table("port")
    jcore, jwitness = _wide_table("jax")
    assert core.digest() == jcore.digest()
    _assert_witness_equal(witness, jwitness)
    validate_witness(core, dict(witness))


@pytest.mark.parametrize("n", [8, 64])
def test_wide_chains_at_the_top_bit(n):
    """The carry and borrow out of the top bit: sums and differences that
    wrap at n bits (64 is DivUU32's width)."""
    m3 = M3ConstraintSystem()
    t = m3.add_table("wide")
    xb = [t.add_committed(f"x{i}", 0, 0) for i in range(n)]
    yb = [t.add_committed(f"y{i}", 0, 0) for i in range(n)]
    add = WideAdd.build(t, "add", xb, yb)
    sub = WideSub.build(t, "sub", xb, yb)
    core, omap = m3.compile([2])
    wi = WitnessIndex(m3, [2])
    tw = wi.table(0)
    top = (1 << n) - 1
    xs = np.array([top, 0, 1 << (n - 1), 5], dtype=np.uint64)
    ys = np.array([1, 1, 1 << (n - 1), 3], dtype=np.uint64)
    for i in range(n):
        tw.set_column(xb[i], ((xs >> np.uint64(i)) & np.uint64(1)).astype(np.uint32))
        tw.set_column(yb[i], ((ys >> np.uint64(i)) & np.uint64(1)).astype(np.uint32))
    assert [int(z) for z in add.populate(tw, xs, ys)] == \
        [(int(x) + int(y)) & top for x, y in zip(xs, ys)]
    assert [int(d) for d in sub.populate(tw, xs, ys)] == \
        [(int(x) - int(y)) & top for x, y in zip(xs, ys)]
    assert [c for c in tw.get_column(add.cout_bits[n - 1])] == [1, 0, 1, 0]
    assert [b for b in tw.get_column(sub.bout_bits[n - 1])] == [0, 1, 0, 0]
    validate_witness(core, wi.to_core_witness(core, omap, "cpu"))


def test_gadget_outputs():
    """The values each populate returns, against integer arithmetic."""
    rng = np.random.default_rng(7)
    xs = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    ys = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    amounts = rng.integers(0, 32, 4, dtype=np.uint64)
    m3 = M3ConstraintSystem()
    t = m3.add_table("ops")
    xin = t.add_committed("xin", 0, 5)
    yin = t.add_committed("yin", 0, 5)
    mulg = U32Mul.build(t, "mul", xin, yin)
    shifters = [bs.BarrelShifter.build(t, name, xin, kind) for name, kind in bs.KINDS]
    wi = WitnessIndex(m3, [2])
    tw = wi.table(0)
    assert [int(v) for v in mulg.populate(tw, xs, ys)] == \
        [(int(a) * int(b)) & M32 for a, b in zip(xs, ys)]
    for g, (_, kind) in zip(shifters, bs.KINDS):
        outs = [int(v) for v in g.populate(tw, xs, amounts, kind)]
        for a, s, o in zip(xs, amounts, outs):
            a, s = int(a), int(s)
            want = {bs.CIRCULAR_LEFT: ((a << s) | (a >> (32 - s))) & M32 if s else a,
                    bs.LOGICAL_LEFT: (a << s) & M32, bs.LOGICAL_RIGHT: a >> s}[kind]
            assert o == want
    m3 = M3ConstraintSystem()
    g = DivUU32.build(m3.add_table("div"), "div")
    wi = WitnessIndex(m3, [2])
    ps, qs = [100, 17, 1 << 31, M32], [7, 5, 1, 65536]
    divs, rems = g.populate(wi.table(0), ps, qs)
    assert [int(d) for d in divs] == [p // q for p, q in zip(ps, qs)]
    assert [int(r) for r in rems] == [p % q for p, q in zip(ps, qs)]


def test_mul_uu32_build_default_columns():
    """MulUU32.build with its own operand columns keeps u32_mul_gkr's
    oracles; with the caller's (DivUU32's q and quotient) it commits none
    of its own."""
    m3 = M3ConstraintSystem()
    t = m3.add_table("mul")
    g = MulUU32.build(t, "mul")
    assert [c.name for c in g.x_bits] == [f"mul.x{i}" for i in range(32)]
    m3 = M3ConstraintSystem()
    t = m3.add_table("mul")
    xb = [t.add_committed(f"a{i}", 0, 0) for i in range(32)]
    yb = [t.add_committed(f"b{i}", 0, 0) for i in range(32)]
    n_cols = len(t.columns)
    g = MulUU32.build(t, "mul", x_bits=xb, y_bits=yb)
    assert g.x_bits is xb and g.y_bits is yb
    assert not any(cd.kind == "committed" and cd.col.name.startswith(("mul.x", "mul.y"))
                   for cd in t.columns[n_cols:])


# -- the bad witnesses of the JAX package's gadget tests ---------------------

def _rejected(m3, tw_fill, log_rows=1):
    core, omap = m3.compile([log_rows])
    wi = WitnessIndex(m3, [log_rows])
    tw_fill(wi.table(0))
    with pytest.raises(ValueError):
        validate_witness(core, wi.to_core_witness(core, omap, "cpu"))


def test_mul_uu32_wrong_output_rejected():
    """`tests/test_mul_gadget.py:57`: bit 7 of out_low flipped in row 1."""
    m3 = M3ConstraintSystem()
    g = MulUU32.build(m3.add_table("mul_exp"), "mul")

    def fill(tw):
        g.populate(tw, [0xDEADBEEF, 3], [0x12345678, 5])
        vals = tw.get_column(g.out_low_bits[7])
        vals[1] ^= 1
        tw.set_column(g.out_low_bits[7], vals)
    _rejected(m3, fill)


def test_u32_mul_bad_bit_rejected():
    """`tests/test_mul_gadget.py:78`: bit 1 of y flipped in row 0."""
    m3 = M3ConstraintSystem()
    t = m3.add_table("mul")
    xin = t.add_committed("xin", 0, 5)
    yin = t.add_committed("yin", 0, 5)
    g = U32Mul.build(t, "mul", xin, yin)

    def fill(tw):
        xs, ys = [7, 9], [3, 5]
        tw.set_packed_ints(xin, xs)
        tw.set_packed_ints(yin, ys)
        g.populate(tw, xs, ys)
        vals = tw.get_packed_ints(g.bit_cols[1])
        vals[0] ^= M32
        tw.set_packed_ints(g.bit_cols[1], vals)
    _rejected(m3, fill)


def test_barrel_shifter_bad_witness_rejected():
    """`tests/test_barrel_shifter.py:43`: bit 2 of stage 2 flipped in row 0."""
    m3 = M3ConstraintSystem()
    t = m3.add_table("shift")
    xin = t.add_committed("xin", 0, 5)
    g = bs.BarrelShifter.build(t, "sh", xin, bs.CIRCULAR_LEFT)

    def fill(tw):
        tw.set_packed_ints(xin, [3, 5])
        g.populate(tw, [3, 5], [7, 1], bs.CIRCULAR_LEFT)
        vals = tw.get_packed_ints(g.stages[2])
        vals[0] ^= 4
        tw.set_packed_ints(g.stages[2], vals)
    _rejected(m3, fill)


def test_div_uu32_wrong_quotient_rejected():
    """`tests/test_div_gadget.py:57`: bit 0 of the quotient flipped in row 0."""
    m3 = M3ConstraintSystem()
    g = DivUU32.build(m3.add_table("div"), "div")

    def fill(tw):
        g.populate(tw, [100, 17], [7, 5])
        vals = tw.get_column(g.div_bits[0])
        vals[0] ^= 1
        tw.set_column(g.div_bits[0], vals)
    _rejected(m3, fill)


def test_div_by_zero_rejected():
    """`tests/test_div_gadget.py:74`: q made 0 in row 1, against the
    non-zero claim."""
    m3 = M3ConstraintSystem()
    g = DivUU32.build(m3.add_table("div"), "div")

    def fill(tw):
        g.populate(tw, [10, 3], [2, 1])
        tw.set_column(g.q_bits[0], [0, 0])
    _rejected(m3, fill)


# -- the golden proofs --------------------------------------------------------

@pytest.fixture(scope="module")
def golden_proofs(built):
    cache = {}

    def get(circuit):
        if circuit not in cache:
            core, witness = built(circuit)[0]
            cache[circuit] = csp.prove(core, witness, log_inv_rate=1, device="cpu")
        return cache[circuit]
    return get


@pytest.mark.parametrize("circuit", GADGETS)
def test_golden_proof_matches_jax_digest(built, golden_proofs, circuit):
    proof = golden_proofs(circuit)
    _, n_bytes, sha = chip_smoke.GOLDEN_CIRCUITS[circuit]
    assert (len(proof), hashlib.sha256(proof).hexdigest()) == (n_bytes, sha)
    assert sum(csp.last_phase_sizes.values()) == n_bytes
    core = built(circuit)[0][0]
    csp.verify(core, proof, log_inv_rate=1, device="cpu")
    bad = bytearray(proof)
    bad[40] ^= 1
    with pytest.raises((ValueError, EOFError)):
        csp.verify(core, bytes(bad), log_inv_rate=1, device="cpu")


def test_reference_verifier_accepts_div_uu32(built, golden_proofs):
    """The JAX verifier on the port's div_uu32 golden proof: the exp walk,
    the non-zero claim's grand product and the rest, on the JAX package's
    own system."""
    from binius_tpu.constraint_system import prove as jcsp

    jcsp.verify(built("div_uu32")[1][0], golden_proofs("div_uu32"), log_inv_rate=1)

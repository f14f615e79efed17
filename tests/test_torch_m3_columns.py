"""The port's M3 column kinds and the helpers the circuits reach, on the
CPU against the JAX package: computed (linear and composite), constant and
fixed columns compiled and materialized as the JAX package does; the
`MultilinearExtensionTransparent` of a fixed pattern; the typed column
readers; B1 linear combinations and 64-bit-block shifts on packed words
against their element-wise forms; the shift indicators of a wave in one
batch; the evaluation domain's interpolation. Exact comparisons."""

import random

import numpy as np
import pytest
import torch

from binius_tpu_torch.constraint_system import oracle as om
from binius_tpu_torch.constraint_system import witness as cw
from binius_tpu_torch.fields import tower
from binius_tpu_torch.m3.builder.table import M3ConstraintSystem, _linearize
from binius_tpu_torch.m3.builder.witness import WitnessIndex
from binius_tpu_torch.math import univariate
from binius_tpu_torch.math.arith import ArithExpr
from binius_tpu_torch.protocols import shift_ind
from binius_tpu_torch.protocols.transparent import MLEFromValues

LOG_ROWS = 3


def _build(pkg):
    """One table of every column kind the port lowers, built with either
    package's builder: (M3 system, columns)."""
    if pkg == "jax":
        from binius_tpu.m3.builder.table import M3ConstraintSystem as M3
        from binius_tpu.math.arith import ArithExpr as E
    else:
        M3, E = M3ConstraintSystem, ArithExpr
    V = E.var
    m3 = M3()
    t = m3.add_table("cols")
    a = t.add_committed("a", 0, 5)
    b = t.add_committed("b", 3, 5)
    c = t.add_committed("c", 0, 5)
    lin = t.add_computed("lin", V(0) + V(1) * E.const(0x35, 3) + E.const(1), [a, b])
    xor = t.add_computed("xor", V(0) + V(1), [a, c])
    comp = t.add_computed("comp", V(0) * V(1) + V(2), [a, b, c])
    const = t.add_constant("const", 5, 0xDEADBEEF, 5)
    fixed = t.add_fixed("fixed", 3, [(7 * i) & 0xFF for i in range(32)], 5)
    rot = t.add_shifted("rot", xor, 3, 5, "circular_left")
    t.assert_zero("z", [a, c, xor], V(0) + V(1) + V(2))
    # a second partition (one value per row), declared between the first's
    # constraints: one constraint set per partition, ascending values per row
    d = t.add_committed("d", 5, 0)
    e = t.add_computed("e", V(0) * V(0), [d])
    t.assert_zero("sq", [e, d], V(0) + V(1) * V(1))
    t.assert_zero("w", [comp, lin, const, fixed, rot], V(0) * V(1) + V(2) * V(3) + V(4),
                  group="ignored")
    return m3, (a, b, c, d)


def _witness(pkg, m3, cols):
    rng = np.random.default_rng(9)
    n = (1 << LOG_ROWS) * 32
    vals = [rng.integers(0, 2, n, dtype=np.uint32), rng.integers(0, 256, n, dtype=np.uint32),
            rng.integers(0, 2, n, dtype=np.uint32),
            rng.integers(0, 1 << 32, 1 << LOG_ROWS, dtype=np.uint32)]
    core, omap = m3.compile([LOG_ROWS])
    if pkg == "jax":
        from binius_tpu.m3.builder.witness import WitnessIndex as WI
        wi = WI(m3, [LOG_ROWS])
    else:
        wi = WitnessIndex(m3, [LOG_ROWS])
    for col, v in zip(cols, vals):
        wi.table(0).set_column(col, v)
    if pkg == "jax":
        w = wi.to_core_witness(core, omap)
    else:
        w = wi.to_core_witness(core, omap, "cpu")
    return core, {oid: (lvl, np.asarray(d) if pkg == "jax" else d.numpy()) for oid, (lvl, d)
                  in w.items()}


def test_column_kinds_compile_and_materialize_as_reference():
    core, w = _witness("port", *_build("port"))
    jcore, jw = _witness("jax", *_build("jax"))
    assert core.digest() == jcore.digest()
    assert [(c.n_vars, c.oracle_ids, len(c.zero_constraints)) for c in core.constraint_sets] \
        == [(c.n_vars, c.oracle_ids, len(c.zero_constraints)) for c in jcore.constraint_sets]
    assert [c.n_vars for c in core.constraint_sets] == [LOG_ROWS, LOG_ROWS + 5]
    kinds = [o.variant for o in core.oracles.oracles]
    assert kinds == [o.variant for o in jcore.oracles.oracles]
    assert {om.LINEAR_COMBINATION, om.COMPOSITE, om.TRANSPARENT, om.REPEATING,
            om.SHIFTED} <= set(kinds)
    for o, j in zip(core.oracles.oracles, jcore.oracles.oracles):
        assert (o.n_vars, o.tower_level, o.inner, o.lc_offset, o.lc_coeffs, o.log_degree,
                o.name) == (j.n_vars, j.tower_level, j.inner, j.lc_offset, j.lc_coeffs,
                            j.log_degree, j.name)
    assert sorted(w) == sorted(jw)
    for oid, (lvl, d) in w.items():
        assert lvl == jw[oid][0], (oid, core.oracles[oid].name)
        assert np.array_equal(d.view(np.uint32), jw[oid][1].view(np.uint32)), oid


def test_linearize_matches_reference():
    from binius_tpu.m3.builder.table import _linearize as jlin
    from binius_tpu.math.arith import ArithExpr as E
    e = ArithExpr.var(0) * ArithExpr.const(0x1234, 4) + ArithExpr.var(2) + ArithExpr.const(9, 4)
    je = E.var(0) * E.const(0x1234, 4) + E.var(2) + E.const(9, 4)
    assert _linearize(e, 3) == jlin(je, 3) == ([0x1234, 0, 1], 9)


@pytest.mark.parametrize("level,n", [(0, 8), (3, 16), (7, 4)])
def test_mle_from_values_matches_reference(level, n):
    from binius_tpu.protocols.transparent import MLEFromValues as JMLE
    rng = random.Random(level)
    vals = tuple(rng.getrandbits(1 << level) for _ in range(n))
    ours, theirs = MLEFromValues(vals, level), JMLE(vals, level)
    assert ours.n_vars == theirs.n_vars
    for _ in range(3):
        q = [rng.getrandbits(128) for _ in range(ours.n_vars)]
        assert ours.evaluate_scalar(q) == theirs.evaluate_scalar(q)
    lvl, d = ours.mle("cpu")
    jl, jd = theirs.mle()
    assert lvl == jl and np.array_equal(d.numpy().view(np.uint32), np.asarray(jd).view(np.uint32))


@pytest.mark.parametrize("log_vpr,n_rows", [(6, 4), (5, 8), (6, 1), (3, 4)])
def test_packed_int_columns_read_back(log_vpr, n_rows):
    m3 = M3ConstraintSystem()
    t = m3.add_table("t")
    col = t.add_committed("x", 0, log_vpr)
    wi = WitnessIndex(m3, [n_rows.bit_length() - 1])
    tw = wi.table(0)
    rng = random.Random(log_vpr)
    ints = [rng.getrandbits(1 << log_vpr) for _ in range(n_rows)]
    tw.set_packed_ints(col, np.array(ints, dtype=np.uint64))
    assert tw.get_packed_ints(col) == ints
    assert tw.get_column(col) == [(v >> i) & 1 for v in ints for i in range(1 << log_vpr)]


@pytest.mark.parametrize("variant", [shift_ind.CIRCULAR_LEFT, shift_ind.LOGICAL_LEFT,
                                     shift_ind.LOGICAL_RIGHT])
@pytest.mark.parametrize("b,o", [(5, 3), (6, 1), (6, 37)])
def test_word_shifts_equal_element_shifts(variant, b, o):
    rng = np.random.default_rng(b + o)
    bits = torch.from_numpy(rng.integers(0, 2, 1 << 10, dtype=np.int32))
    want = shift_ind.apply_shift_device(0, variant, b, o, bits)
    got = tower.unpack_b1(shift_ind.apply_shift_words(variant, b, o, tower.pack_b1(bits)))
    assert torch.equal(got, want)


def test_packed_b1_combination_equals_element_wise():
    """An XOR of bit-packed B1 columns with offset 1 on the packed words
    equals the element-wise combination."""
    oracles = om.OracleSet()
    ids = [oracles.add_committed(8, 0) for _ in range(3)]
    lc = oracles.add_linear_combination(8, [(ids[0], 1), (ids[1], 0), (ids[2], 1)], 1)
    rng = np.random.default_rng(3)
    cols = [torch.from_numpy(rng.integers(0, 2, 256, dtype=np.int32)) for _ in range(3)]
    witness = {oid: (tower.P1, tower.pack_b1(c)) for oid, c in zip(ids, cols)}
    lvl, got = cw.materialize(oracles, witness, lc)
    assert witness[lc][0] == tower.P1 and lvl == 0
    assert torch.equal(got, cols[0] ^ cols[2] ^ 1)


def test_shift_indicators_in_one_batch_match_reference():
    from binius_tpu.protocols import shift_ind as jshift
    rng = random.Random(7)
    variants, offsets, points = [], [], []
    for _ in range(12):
        variants.append(rng.choice([shift_ind.CIRCULAR_LEFT, shift_ind.LOGICAL_LEFT,
                                    shift_ind.LOGICAL_RIGHT]))
        offsets.append(rng.randrange(1, 64))
        points.append([rng.getrandbits(128) for _ in range(6)])
    got = shift_ind.partial_mle_batch(variants, 6, offsets, points, "cpu")
    for i, (v, o, p) in enumerate(zip(variants, offsets, points)):
        want = np.asarray(jshift.partial_mle(v, 6, o, p)).view(np.uint32)
        assert np.array_equal(got[i].numpy().view(np.uint32), want), i


@pytest.mark.parametrize("size", [3, 4, 5, 9])
def test_interpolation_matches_reference(size):
    from binius_tpu.math.univariate import EvaluationDomain as JDomain
    rng = random.Random(size)
    vals = [rng.getrandbits(128) for _ in range(size)]
    ours = univariate.EvaluationDomain.from_subspace(3, size)
    assert ours.interpolate(7, vals) == JDomain.from_subspace(3, size).interpolate(7, vals)


def test_shift_indicator_checks_in_one_batch_match_reference():
    from binius_tpu.protocols import shift_ind as jshift
    rng = random.Random(11)
    vs, bs, offs, xs, ys = [], [], [], [], []
    for _ in range(30):
        b = rng.choice([1, 3, 5, 6])
        vs.append(rng.choice([shift_ind.CIRCULAR_LEFT, shift_ind.LOGICAL_LEFT,
                              shift_ind.LOGICAL_RIGHT]))
        bs.append(b)
        offs.append(rng.randrange(1, 1 << b))
        xs.append([rng.getrandbits(128) for _ in range(b)])
        ys.append([rng.getrandbits(128) for _ in range(b)])
    got = shift_ind.evaluate_scalar_batch(vs, bs, offs, xs, ys)
    assert got == jshift.evaluate_scalar_batch(vs, bs, offs, xs, ys)
    assert got == [shift_ind.evaluate_scalar(*a) for a in zip(vs, bs, offs, xs, ys)]

"""The port's M3 emulation channels (`m3/emulate.py`), table statistics
(`m3/builder/stat.py`, `TableBuilder.stat`) and small instances
(`m3/instances.py`) on the CPU against the JAX package's.

The four cases of `tests/test_emulate_stat.py` are mirrored; the
statistics' text of the demo table and of the u32_mul, barrel_shifter
and div_uu32 tables equals the JAX package's; the two instances have the
JAX package's system digest and witness, byte for byte."""

import numpy as np
import pytest
import torch

from binius_tpu_torch.convert import to_reference
from binius_tpu_torch.m3.builder.table import M3ConstraintSystem
from binius_tpu_torch.m3.emulate import Channel
from binius_tpu_torch.math.arith import ArithExpr

torch.set_num_threads(1)  # the suite's test processes share the cores


def test_channel_balance():
    ch = Channel()
    ch.push((1, 2))
    ch.push((1, 2))
    ch.pull((1, 2))
    assert not ch.is_balanced()
    ch.pull((1, 2))
    assert ch.is_balanced()
    ch.assert_balanced()


def test_channel_pull_before_push():
    ch = Channel()
    ch.pull(5)
    assert not ch.is_balanced()
    ch.push(5)
    assert ch.is_balanced()


def test_channel_assert_message():
    from binius_tpu.m3.emulate import Channel as JChannel

    messages = []
    for cls in (Channel, JChannel):
        ch = cls()
        for v in ("a", "c", "a"):
            ch.push(v)
        ch.pull("b")
        with pytest.raises(AssertionError, match="Unbalanced push") as e:
            ch.assert_balanced()
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def _demo(pkg):
    cs = pkg.M3ConstraintSystem()
    t = cs.add_table("demo")
    x = t.add_committed("x", 5, 0)
    y = t.add_committed("y", 5, 0)
    bits = t.add_committed("bits", 0, 5)
    z = t.add_computed("z", pkg.ArithExpr.var(0) * pkg.ArithExpr.var(1), [x, y])
    ch = cs.add_channel()
    t.push(ch, [x], multiplicity=2)
    t.pull(ch, [y])
    v0, v1 = pkg.ArithExpr.var(0), pkg.ArithExpr.var(1)
    t.assert_zero("mul", [x, y, z], v0 * v1 + pkg.ArithExpr.var(2))
    t.assert_zero("bool", [bits], v0 * v0 + v0)
    t.assert_zero("cube", [x], v0 ** 3 + v0)
    return t


class _Port:
    M3ConstraintSystem = M3ConstraintSystem
    ArithExpr = ArithExpr


class _Jax:
    from binius_tpu.m3.builder.table import M3ConstraintSystem
    from binius_tpu.math.arith import ArithExpr


def test_table_stat():
    st = _demo(_Port).stat()
    # committed: x (32) + y (32) + bits (1 bit * 32 vpr)
    assert st.bits_per_row_committed == 32 + 32 + 32
    assert st.bits_per_row_virtual == 128  # computed z at B128
    assert st.total_flush_count == 3
    assert st.assert_zero_cost_approx() > 0
    text = str(st)
    assert "mul" in text and "bool" in text and "flush count: 3" in text
    assert text == str(_demo(_Jax).stat())


def _gadget_table(circuit, jax):
    if jax:
        from binius_tpu.m3.builder.table import M3ConstraintSystem as M3
        from binius_tpu.m3.gadgets import barrel_shifter as bs, div, mul
    else:
        from binius_tpu_torch.m3.gadgets import barrel_shifter as bs, div, mul
        M3 = M3ConstraintSystem
    t = M3().add_table(circuit)
    if circuit == "div_uu32":
        div.DivUU32.build(t, "div")
        return t
    xin = t.add_committed("xin", 0, 5)
    if circuit == "u32_mul":
        mul.U32Mul.build(t, "mul", xin, t.add_committed("yin", 0, 5))
    else:
        bs.BarrelShifter.build(t, "sh", xin, bs.LOGICAL_RIGHT)
    return t


@pytest.mark.parametrize("circuit", ["u32_mul", "barrel_shifter", "div_uu32"])
def test_gadget_table_stat_equals_reference(circuit):
    ours, theirs = _gadget_table(circuit, False).stat(), _gadget_table(circuit, True).stat()
    assert str(ours) == str(theirs)
    assert ours.assert_zero_cost_approx() == theirs.assert_zero_cost_approx()


@pytest.mark.parametrize("name", ["u32_add_instance", "grouped_lookup_exp_instance"])
def test_instance_equals_reference(name):
    from binius_tpu.m3 import instances as jinstances
    from binius_tpu_torch.m3 import instances

    core, witness = getattr(instances, name)(device="cpu")
    jcore, jwitness = getattr(jinstances, name)()
    assert core.digest() == jcore.digest()
    assert sorted(witness) == sorted(jwitness)
    for oid, (lvl, d) in witness.items():
        jl, jd = jwitness[oid]
        assert lvl == jl, oid
        assert np.array_equal(to_reference(d), np.asarray(jd).view(np.uint32)), oid

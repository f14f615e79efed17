"""Small M3 instances: a whole system and its witness in a few rows.

The port of `binius_tpu/m3/instances.py`: the smallest u32_add instance
that runs every phase of the main path, and a miniature of the keccak
class of systems (indexed lookups through channels, the GKR
exponentiation phase and two tables of one structure). Each returns
(core system, witness on `device`), CUDA unless the caller names
another device.
"""

from __future__ import annotations

import random


def u32_add_instance(log_rows: int = 4, seed: int = 5, device=None):
    """One u32_add table of 2^log_rows rows from `random.Random(seed)`."""
    from .builder.table import M3ConstraintSystem
    from .builder.witness import WitnessIndex
    from .gadgets import arith

    prng = random.Random(seed)
    n_rows = 1 << log_rows
    m3 = M3ConstraintSystem()
    t = m3.add_table("u32add")
    xin = t.add_committed("xin", 0, arith.LOG_U32)
    yin = t.add_committed("yin", 0, arith.LOG_U32)
    adder = arith.U32Add.build(t, "add", xin, yin)
    core, omap = m3.compile([log_rows])
    wi = WitnessIndex(m3, [log_rows])
    tw = wi.table(0)
    xs = [prng.getrandbits(32) for _ in range(n_rows)]
    ys = [prng.getrandbits(32) for _ in range(n_rows)]
    tw.set_packed_ints(xin, xs)
    tw.set_packed_ints(yin, ys)
    adder.populate(tw, xs, ys)
    return core, wi.to_core_witness(core, omap, device)


def grouped_lookup_exp_instance(seed: int = 17, device=None):
    """The increment lookup with 8 lookers, two u32_add tables of one
    structure and 4 `MulUU32` products, from `random.Random(seed)`."""
    from .builder.table import M3ConstraintSystem
    from .builder.witness import WitnessIndex
    from .gadgets import arith
    from .gadgets.indexed_lookup import IncrLooker, IncrLookup
    from .gadgets.mul import MulUU32

    rng = random.Random(seed)
    m3 = M3ConstraintSystem()
    lookup_chan = m3.add_channel()
    perm_chan = m3.add_channel()
    lut = IncrLookup.build(m3.add_table("incr_lookup"), lookup_chan, perm_chan, 4)
    looker = IncrLooker.build(m3.add_table("lookers"), "incr", lookup_chan)
    adders = []
    for name in ("add_a", "add_b"):
        t = m3.add_table(name)
        xin = t.add_committed("xin", 0, arith.LOG_U32)
        yin = t.add_committed("yin", 0, arith.LOG_U32)
        adders.append((xin, yin, arith.U32Add.build(t, "add", xin, yin)))
    gm = MulUU32.build(m3.add_table("mul_exp"), "mul")

    log_sizes = [9, 3, 5, 5, 2]
    core, omap = m3.compile(log_sizes)
    wi = WitnessIndex(m3, log_sizes)
    events = [(rng.getrandbits(8), rng.getrandbits(1)) for _ in range(1 << 3)]
    looker.populate(wi.table(1), events)
    counts = [0] * 512
    for i, c in events:
        counts[(c << 8) | i] += 1
    lut.populate(wi.table(0), sorted(enumerate(counts), key=lambda ic: -ic[1]))
    for ti, (xin, yin, adder) in enumerate(adders):
        tw = wi.table(2 + ti)
        xs = [rng.getrandbits(32) for _ in range(1 << 5)]
        ys = [rng.getrandbits(32) for _ in range(1 << 5)]
        tw.set_packed_ints(xin, xs)
        tw.set_packed_ints(yin, ys)
        adder.populate(tw, xs, ys)
    gm.populate(wi.table(4), [rng.getrandbits(32) for _ in range(4)],
                [rng.getrandbits(32) for _ in range(4)])
    return core, wi.to_core_witness(core, omap, device)

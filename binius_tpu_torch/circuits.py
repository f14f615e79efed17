"""The circuits the port proves, by name: seeded instances at a size.

Each instance is built the way the repo's example of that circuit builds
it, from inputs drawn from `seed` with the generator the example uses:

- `u32_add`: an M3 table of 2^size u32 additions (`m3.gadgets.arith`);
- `b32_mul`: 2^size B32 products, a hand-built system
  (`m3.gadgets.b32_mul`, `examples/b32_mul.py`);
- `keccak`: 2^size Keccak-f[1600] permutations (`m3.gadgets.keccak`,
  `examples/keccak.py`);
- `groestl`: 2^size Grøstl P permutations (`m3.gadgets.groestl`,
  `examples/groestl.py`);
- `u32_mul_gkr`: 2^size full u32 products through the GKR
  exponentiation phase (`m3.gadgets.mul.MulUU32`,
  `examples/u32_mul_gkr.py`);
- `bitwise_ops`: 2^size rows of u32 AND, XOR and OR
  (`m3.gadgets.arith`, `examples/bitwise_ops.py`). The upstream grid
  proves the three ops as three instances; this one, as the JAX package's
  example does, holds the three in one table;
- `keccak_lookups`: 2^size Keccak-f[1600] permutations with chi checked
  through the bit-AND lookup channel, and the 4-row lookup table
  (`m3.gadgets.keccak.KeccakLookedupCS`, `examples/keccak_lookups.py`,
  whose `random.seed(seed)` draws the lanes `keccak_inputs` draws from
  `random.Random(seed)`); its table sizes [2^size, 4] are the proof's
  first message;
- `sha256`: 2^size SHA-256 compressions (`m3.gadgets.sha256`,
  `examples/sha256.py`, whose `random.seed(seed)` draws the message words
  `sha256_inputs` draws from `random.Random(seed)`);
- `merkle_tree`: inclusion proofs of `merkle_opened(size)` leaves in a
  Grøstl-256 Merkle tree of 2^size leaves (`m3.gadgets.merkle_tree`,
  `examples/merkle_tree.py`, its leaves and opened indices drawn by
  `merkle_inputs`): the increment lookup, three nodes tables and the
  roots table, the opened leaves and the root as boundaries; its
  boundaries and table sizes are the statement;
- the channel systems (`CHANNEL_SYSTEMS`, `channel_system`): the
  hand-built systems of the JAX package's channel and lookup tests on
  2^size rows: a permutation channel, boundaries, selector flushes, a
  lookup with multiplicity bits, a non-zero claim.

`GRID_SIZE` is each circuit's size in the reference grid (the benchmark
sizes of the upstream project's record), and keccak_lookups' at the
keccak grid's size. `CARD_SIZE` holds the sizes `chip_smoke.py` proves
the two examples outside the grid at: sha256 2^14 compressions (its
committed columns 2^19 bits each, as keccak's at 2^13) and merkle_tree
2^20 leaves with 2^12 opened.
"""

from __future__ import annotations

import random

CIRCUITS = ("u32_add", "b32_mul", "keccak", "groestl", "u32_mul_gkr", "bitwise_ops",
            "keccak_lookups", "sha256", "merkle_tree")
GRID_SIZE = {"u32_add": 22, "b32_mul": 20, "keccak": 13, "groestl": 14,
             "u32_mul_gkr": 20, "bitwise_ops": 22, "keccak_lookups": 13}
CARD_SIZE = {"sha256": 14, "merkle_tree": 20}
# merkle_tree: the opened leaves of a tree of 2^size leaves; the example's
# own instance (16 leaves, 3 opened), a 64-leaf one in which every nodes
# table has rows, and the card's
MERKLE_OPENED = {4: 3, 6: 8, 20: 1 << 12}


def merkle_opened(size: int) -> int:
    """The number of opened leaves of the merkle_tree instance of 2^size
    leaves: `MERKLE_OPENED`, else 2^(size - 8) (at least one)."""
    return MERKLE_OPENED.get(size, 1 << max(0, size - 8))
CHANNEL_SYSTEMS = ("perm_channel", "boundary", "selector_flush", "lookup_flush", "nonzero")


def instance(circuit: str, size: int, seed: int, device=None):
    """(core system, witness on `device`, statement) of one seeded instance
    (CUDA unless `device` names another): the statement is the keywords
    that `prove` and `verify` take with it (boundaries, table sizes),
    empty for a circuit that has none."""
    if circuit in CHANNEL_SYSTEMS:
        return channel_system(circuit, size, seed, device)
    if circuit == "keccak_lookups":
        from .m3.gadgets import keccak
        core, witness, sizes, _ = keccak.keccak_lookups_system(
            1 << size, keccak.keccak_inputs(size, seed), device)
        return core, witness, {"table_sizes": sizes}
    if circuit == "merkle_tree":
        from .m3.gadgets import merkle_tree
        leaves, opened = merkle_tree.merkle_inputs(size, merkle_opened(size), seed)
        return merkle_tree.merkle_system(leaves, opened, device)[:3]
    if circuit == "sha256":
        from .m3.gadgets import sha256
        return (*sha256.sha256_system(size, sha256.sha256_inputs(size, seed), device)[:2], {})
    return (*_grid_instance(circuit, size, seed, device), {})


def _grid_instance(circuit: str, size: int, seed: int, device):
    if circuit == "u32_add":
        from .m3.gadgets import arith
        return arith.u32_add_system(size, *arith.u32_add_rows(size, seed), device)
    if circuit == "b32_mul":
        from .m3.gadgets import b32_mul
        core = b32_mul.b32_mul_system(size)
        return core, b32_mul.b32_mul_witness(core, *b32_mul.b32_mul_inputs(size, seed), device)
    if circuit == "keccak":
        from .m3.gadgets import keccak
        return keccak.keccak_system(size, keccak.keccak_inputs(size, seed), device)[:2]
    if circuit == "groestl":
        from .m3.gadgets import groestl
        return groestl.groestl_system(size, groestl.groestl_inputs(size, seed), device)[:2]
    if circuit == "u32_mul_gkr":
        from .m3.gadgets import mul
        return mul.mul_system(size, *mul.mul_inputs(size, seed), device)
    if circuit == "bitwise_ops":
        from .m3.gadgets import arith
        return arith.bitwise_system(size, *arith.u32_add_rows(size, seed), device)
    raise ValueError(f"unknown circuit {circuit!r}")


def channel_system(name: str, size: int, seed: int, device=None):
    """(core system, witness on `device`, statement) of a hand-built
    channel system on 2^size rows of B32 columns, the values drawn from
    `random.Random(seed)` in the order written here:

    - `perm_channel`: a pushed into channel 0, b (a shuffled) pulled;
    - `boundary`: a pulled, each of its values pushed as a boundary;
    - `selector_flush`: a pushed where sel (1, 0, 1, 1, 0, 0, 1, 0 per 8
      rows) is 1, b pulled where sel_b is 1 (the selected values first);
    - `lookup_flush`: the table (t_idx, t_val = t_idx^2 mod 256) pushed
      with multiplicity 1 where m0 is 1 and 2 where m1 is 1, the reads
      (r_idx, r_val) pulled (reads redrawn until no count exceeds 3);
    - `nonzero`: a non-zero claim on a (odd values)."""
    from .constraint_system import oracle as om
    from .constraint_system.system import (PULL, PUSH, Boundary, ConstraintSystem, Flush,
                                           NonZeroClaim)
    from .device import resolve
    from .fields import tower

    dev = resolve(device)
    rng = random.Random(seed)
    n = 1 << size
    oracles = om.OracleSet()
    cols, statement = {}, {}

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
        statement["boundaries"] = [Boundary(0, PUSH, (v,)) for v in a]
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
        raise ValueError(f"unknown channel system {name!r}")
    return system, {oid: (5, tower.from_ints(5, v, dev)) for oid, v in cols.items()}, statement

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
  example does, holds the three in one table.

`GRID_SIZE` is each circuit's size in the reference grid (the benchmark
sizes of the upstream project's record).
"""

from __future__ import annotations

CIRCUITS = ("u32_add", "b32_mul", "keccak", "groestl", "u32_mul_gkr", "bitwise_ops")
GRID_SIZE = {"u32_add": 22, "b32_mul": 20, "keccak": 13, "groestl": 14,
             "u32_mul_gkr": 20, "bitwise_ops": 22}


def instance(circuit: str, size: int, seed: int, device=None):
    """(core system, witness on `device`) of one seeded instance (CUDA
    unless `device` names another)."""
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

"""Multilinear oracle set: registry of committed and virtual multilinears.

The port's copy of `binius_tpu/constraint_system/oracle.py`: Committed,
Transparent, Shifted, LinearCombination, Repeating, Packed, ZeroPadded,
Composite and Projected oracles, each identified by a dense integer id.
`constraint_system/witness.py` materializes each kind and
`protocols/evalcheck.py` reduces claims on each.
"""

from __future__ import annotations

import dataclasses

COMMITTED = "committed"
TRANSPARENT = "transparent"
SHIFTED = "shifted"
LINEAR_COMBINATION = "linear_combination"
REPEATING = "repeating"
PACKED = "packed"
ZERO_PADDED = "zero_padded"
COMPOSITE = "composite"
PROJECTED = "projected"


@dataclasses.dataclass(frozen=True)
class Oracle:
    id: int
    n_vars: int
    tower_level: int
    variant: str
    inner: tuple = ()          # inner oracle ids
    shift_offset: int = 0
    shift_block_bits: int = 0
    shift_variant: str = ""
    lc_offset: int = 0         # constant term (B128 int)
    lc_coeffs: tuple = ()      # per-inner coefficients (B128 ints)
    log_degree: int = 0        # packed: log extension degree; repeating: log count
    transparent: object = None  # TransparentPoly (n_vars, level, evaluate_scalar, mle)
    composite: object = None   # ArithExpr over the inner oracles (COMPOSITE)
    proj_values: tuple = ()    # projected: B128 values bound to inner vars
    start_index: int = 0       # projected / zero_padded: first bound/pad var
    nonzero_index: int = 0     # zero_padded: surviving block index
    name: str = ""


class OracleSet:
    def __init__(self):
        self.oracles: list[Oracle] = []

    def __getitem__(self, oid: int) -> Oracle:
        return self.oracles[oid]

    def __len__(self) -> int:
        return len(self.oracles)

    def _add(self, **kw) -> int:
        oid = len(self.oracles)
        self.oracles.append(Oracle(id=oid, **kw))
        return oid

    def add_committed(self, n_vars: int, tower_level: int, name: str = "") -> int:
        return self._add(n_vars=n_vars, tower_level=tower_level, variant=COMMITTED, name=name)

    def add_transparent(self, poly, name: str = "") -> int:
        return self._add(n_vars=poly.n_vars, tower_level=poly.level, variant=TRANSPARENT,
                         transparent=poly, name=name)

    def add_shifted(self, inner_id: int, offset: int, block_bits: int, variant: str,
                    name: str = "") -> int:
        inner = self[inner_id]
        assert 0 < offset < (1 << block_bits) and block_bits <= inner.n_vars
        return self._add(n_vars=inner.n_vars, tower_level=inner.tower_level,
                         variant=SHIFTED, inner=(inner_id,), shift_offset=offset,
                         shift_block_bits=block_bits, shift_variant=variant, name=name)

    def add_linear_combination(self, n_vars: int, terms, offset: int = 0,
                               name: str = "") -> int:
        """terms: [(inner_id, coeff B128 int)]; result level is 7."""
        for oid, _ in terms:
            assert self[oid].n_vars == n_vars
        return self._add(n_vars=n_vars, tower_level=7, variant=LINEAR_COMBINATION,
                         inner=tuple(oid for oid, _ in terms),
                         lc_coeffs=tuple(c for _, c in terms), lc_offset=offset, name=name)

    def add_repeating(self, inner_id: int, log_count: int, name: str = "") -> int:
        inner = self[inner_id]
        return self._add(n_vars=inner.n_vars + log_count, tower_level=inner.tower_level,
                         variant=REPEATING, inner=(inner_id,), log_degree=log_count,
                         name=name)

    def add_packed(self, inner_id: int, log_degree: int, name: str = "") -> int:
        inner = self[inner_id]
        assert inner.n_vars >= log_degree
        return self._add(n_vars=inner.n_vars - log_degree,
                         tower_level=inner.tower_level + log_degree, variant=PACKED,
                         inner=(inner_id,), log_degree=log_degree, name=name)

    def add_composite(self, n_vars: int, inner_ids: list, expr, name: str = "") -> int:
        """Pointwise composite of inner oracles: value = expr(inner_0, ...)."""
        for oid in inner_ids:
            assert self[oid].n_vars == n_vars
        return self._add(n_vars=n_vars, tower_level=7, variant=COMPOSITE,
                         inner=tuple(inner_ids), composite=expr, name=name)

    def add_projected(self, inner_id: int, values: tuple, start_index: int = 0,
                      name: str = "") -> int:
        """Bind inner vars [start_index, start_index+len(values)) to constant
        B128 values."""
        inner = self[inner_id]
        assert len(values) + start_index <= inner.n_vars
        return self._add(n_vars=inner.n_vars - len(values), tower_level=7,
                         variant=PROJECTED, inner=(inner_id,),
                         proj_values=tuple(int(v) for v in values),
                         start_index=start_index, name=name)

    def add_zero_padded(self, inner_id: int, n_pad_vars: int, nonzero_index: int,
                        start_index: int = None, name: str = "") -> int:
        """Insert n_pad_vars block-index variables at start_index; the data
        is zero except block `nonzero_index`, which holds the inner oracle."""
        inner = self[inner_id]
        if start_index is None:
            start_index = inner.n_vars
        assert start_index <= inner.n_vars
        assert nonzero_index < 1 << n_pad_vars
        return self._add(n_vars=inner.n_vars + n_pad_vars,
                         tower_level=inner.tower_level, variant=ZERO_PADDED,
                         inner=(inner_id,), log_degree=n_pad_vars,
                         nonzero_index=nonzero_index, start_index=start_index,
                         name=name)

    def committed_ids(self) -> list[int]:
        return [o.id for o in self.oracles if o.variant == COMMITTED]

    def clone(self) -> "OracleSet":
        c = OracleSet()
        c.oracles = list(self.oracles)
        return c

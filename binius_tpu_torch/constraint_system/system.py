"""Constraint system definition.

The port of `binius_tpu/constraint_system/system.py`: a set of
multilinear oracles, zero-constraint sets over them, channel flushes,
non-zero claims and exponents; the digest the proof observes first (the
canonical serialization of an M3-built system, or a structural hash of a
hand-built one); and `validate_witness`, which checks a witness against
the constraints directly, without proving.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from ..fields import tower
from ..hash.groestl import groestl256
from . import oracle as om

PUSH = "push"
PULL = "pull"


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Zero constraints over a fixed list of oracles of equal n_vars."""

    n_vars: int
    oracle_ids: tuple
    zero_constraints: tuple  # tuple[ArithExpr] over local var indices


@dataclasses.dataclass(frozen=True)
class Flush:
    """A multiset flush of (col_0[r], ..., col_{k-1}[r]) for every row r
    into `channel_id` (PUSH) or out of it (PULL); with selectors only the
    rows where all of them are 1."""

    channel_id: int
    direction: str  # PUSH | PULL
    oracle_ids: tuple
    multiplicity: int = 1
    selector_ids: tuple = ()


@dataclasses.dataclass(frozen=True)
class Boundary:
    """A statement-level (public) tuple pushed or pulled on a channel."""

    channel_id: int
    direction: str
    values: tuple  # B128 ints
    multiplicity: int = 1


@dataclasses.dataclass(frozen=True)
class NonZeroClaim:
    """An oracle that must be non-zero everywhere."""

    oracle_id: int


@dataclasses.dataclass
class ConstraintSystem:
    oracles: om.OracleSet
    constraint_sets: list                # list[ConstraintSet]
    flushes: list = dataclasses.field(default_factory=list)
    n_channels: int = 0
    non_zero_claims: list = dataclasses.field(default_factory=list)
    exponents: list = dataclasses.field(default_factory=list)
    symbolic: object = None              # canonical.SymbolicSystem (M3-built)

    def digest(self) -> bytes:
        """Grøstl-256 of the canonical serialization of the sizeless
        symbolic system when the M3 builder made it; a hand-built system
        hashes the `repr` of a structural token list of its sized form
        instead. Cached."""
        got = self.__dict__.get("_digest_cache")
        if got is None:
            got = self.__dict__["_digest_cache"] = self._digest_uncached()
        return got

    def _digest_uncached(self) -> bytes:
        if self.symbolic is not None:
            from . import canonical
            return canonical.digest(self.symbolic)
        toks = []
        for o in self.oracles.oracles:
            toks.append((o.id, o.n_vars, o.tower_level, o.variant, o.inner,
                         o.shift_offset, o.shift_block_bits, o.shift_variant,
                         o.lc_offset, o.lc_coeffs, o.log_degree))
        for cs in self.constraint_sets:
            toks.append((cs.n_vars, cs.oracle_ids,
                         tuple(c.serialize_tokens() for c in cs.zero_constraints)))
        for f in self.flushes:
            toks.append((f.channel_id, f.direction, f.oracle_ids, f.multiplicity,
                         f.selector_ids))
        toks.append(("channels", self.n_channels))
        for nz in self.non_zero_claims:
            toks.append(("nonzero", nz.oracle_id))
        for e in self.exponents:
            toks.append(e.tokens())
        return groestl256(repr(toks).encode())


def validate_witness(system: ConstraintSystem, witness: dict, boundaries=()) -> None:
    """Check every zero constraint, non-zero claim and channel balance
    directly against the witness (oracle id -> (level, tensor)); raises
    ValueError on the first violation. Each constraint set is evaluated at
    the smallest level that holds its columns and constants: a subfield is
    closed under the field operations, so a value is zero there exactly
    when it is zero in B128. Each exponent's result column is recomputed
    from its bits and base and compared."""
    from . import witness as witness_mod

    _validate_channels(system, witness, boundaries)
    _validate_exponents(system, witness)
    for nz in system.non_zero_claims:
        level, data = witness_mod.materialize(system.oracles, witness, nz.oracle_id)
        if bool(torch.any(tower.is_zero(max(level, 0), data))):
            raise ValueError(f"non-zero claim violated on oracle {nz.oracle_id}")
    for cs in system.constraint_sets:
        cols = [witness_mod.materialize(system.oracles, witness, oid) for oid in cs.oracle_ids]
        level = max([0, *(lvl for lvl, _ in cols),
                     *(e.binary_tower_level() for e in cs.zero_constraints)])
        mls = [tower.embed(lvl, level, d) if lvl < level else d for lvl, d in cols]
        for k, expr in enumerate(cs.zero_constraints):
            if bool(torch.any(expr.evaluate(level, mls) != 0)):
                raise ValueError(f"zero constraint {k} violated on oracles {cs.oracle_ids}")


def _validate_exponents(system: ConstraintSystem, witness: dict) -> None:
    """Each exp-result column against base^exponent recomputed from its
    bit columns."""
    if not system.exponents:
        return
    from . import exp as exp_mod

    recomputed = dict(witness)
    exp_mod.make_exp_witnesses(system, recomputed)
    for e in system.exponents:
        lvl, have = tower.resolve_p1(*witness[e.exp_result_id])
        rlvl, want = tower.resolve_p1(*recomputed[e.exp_result_id])
        assert lvl == rlvl
        if not torch.equal(have, want):
            raise ValueError(f"exp result column (oracle {e.exp_result_id}) does not match "
                             f"base^exponent")


def _validate_channels(system: ConstraintSystem, witness: dict, boundaries) -> None:
    """Exact multiset balance of every channel: the flushes' row tuples
    (rows whose selectors are all 1) against the boundaries."""
    if not system.flushes and not boundaries:
        return
    from . import witness as witness_mod

    counters = [Counter() for _ in range(system.n_channels)]

    def account(channel, direction, tup, mult):
        counters[channel][tup] += mult if direction == PUSH else -mult

    for f in system.flushes:
        cols = [tower.to_ints(*witness_mod.materialize(system.oracles, witness, oid))
                for oid in f.oracle_ids]
        sels = [tower.to_ints(*witness_mod.materialize(system.oracles, witness, sid))
                for sid in f.selector_ids]
        for r in range(len(cols[0])):
            if any(s[r] == 0 for s in sels):
                continue
            account(f.channel_id, f.direction, tuple(c[r] for c in cols), f.multiplicity)
    for b in boundaries:
        account(b.channel_id, b.direction, tuple(b.values), b.multiplicity)
    for c, counter in enumerate(counters):
        bad = {k: v for k, v in counter.items() if v != 0}
        if bad:
            raise ValueError(f"channel {c} is not balanced: {len(bad)} unbalanced tuples")

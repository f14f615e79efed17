"""Constraint system definition.

The port of `binius_tpu/constraint_system/system.py` (without its witness
validator, and with the digest of M3-built systems only): a set of
multilinear oracles, zero-constraint sets over them, channel flushes,
non-zero claims and exponents, and the digest the proof observes first.
"""

from __future__ import annotations

import dataclasses

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
        symbolic system the M3 builder records. Cached."""
        got = self.__dict__.get("_digest_cache")
        if got is None:
            from . import canonical
            got = self.__dict__["_digest_cache"] = canonical.digest(self.symbolic)
        return got

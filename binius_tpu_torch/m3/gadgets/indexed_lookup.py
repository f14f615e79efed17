"""Indexed lookup tables: 8-bit increment with carry, and bitwise AND.

The port of `binius_tpu/m3/gadgets/indexed_lookup.py`: a lookup table of
fixed 2^k rows whose entries in index order are a structured column of
the row index (the verifier evaluates it), a committed sorted copy tied
to it by a permutation channel, and a `LookupProducer` that pushes the
sorted entries on the lookup channel. Lookers commit their outputs and
pull the merged encoding.

Merged encodings (integers as B32 elements):
  incr: input | output << 8 | carry_in << 16 | carry_out << 17
  and:  in_a | in_b << n | (in_a & in_b) << 2n  (n = 8 in the reference)
"""

from __future__ import annotations

import dataclasses

from ...math.arith import ArithExpr
from ..builder.table import Col, TableBuilder
from .lookup import LookupProducer

V = ArithExpr.var


def _c(v: int) -> ArithExpr:
    return ArithExpr.const(v, 7)


# ---------------------------------------------------------------------------
# increment with carry (9-bit index: 8 input bits + carry_in)
# ---------------------------------------------------------------------------

INCR_LOG_SIZE = 9


def incr_carry_expr(i: int) -> ArithExpr:
    """Carry into bit i of input + carry_in: carry_in * prod_{j<i} input_j."""
    e = V(8)
    for j in range(i):
        e = e * V(j)
    return e


def incr_merged_expr() -> ArithExpr:
    """The merged incr entry as a multilinear expression of the 9 index bits."""
    e = None
    for i in range(8):
        term = V(i) * _c(1 << i)                           # input
        e = term if e is None else e + term
    for i in range(8):
        e = e + (V(i) + incr_carry_expr(i)) * _c(1 << (8 + i))  # output
    e = e + V(8) * _c(1 << 16)                             # carry_in
    e = e + incr_carry_expr(8) * _c(1 << 17)               # carry_out
    return e


def merge_incr_vals(inp: int, cin: int, out: int, cout: int) -> int:
    return (cout << 17) | (cin << 16) | (out << 8) | inp


def incr_index_to_entry(index: int) -> int:
    inp = index & 0xFF
    cin = (index >> 8) & 1
    s = inp + cin
    return merge_incr_vals(inp, cin, s & 0xFF, s >> 8)


@dataclasses.dataclass
class Incr:
    """The looker's increment: commits output and carry_out, pulls the
    merged encoding from the lookup channel."""

    input: Col
    carry_in: Col
    output: Col
    carry_out: Col
    merged: Col

    @staticmethod
    def build(t: TableBuilder, name: str, lookup_channel: int,
              input_col: Col, carry_in: Col) -> "Incr":
        output = t.add_committed(f"{name}.output", 3, 0)
        carry_out = t.add_committed(f"{name}.carry_out", 0, 0)
        merged = t.add_computed(
            f"{name}.merged",
            V(0) + V(1) * _c(1 << 8) + V(2) * _c(1 << 16) + V(3) * _c(1 << 17),
            [input_col, output, carry_in, carry_out])
        t.pull(lookup_channel, [merged])
        return Incr(input_col, carry_in, output, carry_out, merged)

    def populate(self, tw, events: list) -> list:
        """events: [(input_byte, carry_in_bit)]; returns output bytes."""
        outs = [(i + c) & 0xFF for i, c in events]
        couts = [(i + c) >> 8 for i, c in events]
        tw.set_column(self.output, outs)
        tw.set_column(self.carry_out, couts)
        return outs


@dataclasses.dataclass
class IncrLooker:
    """An increment looker that commits its inputs too."""

    input: Col
    carry_in: Col
    incr: Incr

    @staticmethod
    def build(t: TableBuilder, name: str, lookup_channel: int) -> "IncrLooker":
        input_col = t.add_committed(f"{name}.input", 3, 0)
        carry_in = t.add_committed(f"{name}.carry_in", 0, 0)
        incr = Incr.build(t, name, lookup_channel, input_col, carry_in)
        return IncrLooker(input_col, carry_in, incr)

    def populate(self, tw, events: list) -> list:
        tw.set_column(self.input, [i for i, _ in events])
        tw.set_column(self.carry_in, [c for _, c in events])
        return self.incr.populate(tw, events)


@dataclasses.dataclass
class IncrLookup:
    """The increment table: 512 fixed rows, the structured entries in index
    order, a committed sorted copy, the permutation channel between them
    and a LookupProducer."""

    entries_ordered: Col
    entries_sorted: Col
    producer: LookupProducer

    @staticmethod
    def build(t: TableBuilder, lookup_channel: int, permutation_channel: int,
              n_multiplicity_bits: int) -> "IncrLookup":
        t.require_fixed_size(INCR_LOG_SIZE)
        ordered = t.add_structured("incr_lookup", 5, incr_merged_expr())
        sorted_ = t.add_committed("entries_sorted", 5, 0)
        t.push(permutation_channel, [ordered])
        t.pull(permutation_channel, [sorted_])
        producer = LookupProducer.build(t, "incr", lookup_channel, [sorted_],
                                        n_multiplicity_bits)
        return IncrLookup(ordered, sorted_, producer)

    def populate(self, tw, index_counts: list) -> None:
        """index_counts: [(index, count)] covering all 512 indices (any
        order; typically sorted descending by count)."""
        assert len(index_counts) == 1 << INCR_LOG_SIZE
        tw.set_column(self.entries_sorted,
                      [incr_index_to_entry(i) for i, _ in index_counts])
        self.producer.populate(tw, [c for _, c in index_counts])


# ---------------------------------------------------------------------------
# bitwise AND (2n-bit index: n bits of a, n bits of b); reference n = 8
# ---------------------------------------------------------------------------

def bitand_merged_expr(n_bits: int = 8) -> ArithExpr:
    """a | b << n | (a & b) << 2n as a multilinear expr of 2n index bits."""
    e = None
    for i in range(n_bits):
        term = V(i) * _c(1 << i)
        e = term if e is None else e + term
    for i in range(n_bits):
        e = e + V(n_bits + i) * _c(1 << (n_bits + i))
    for i in range(n_bits):
        e = e + V(i) * V(n_bits + i) * _c(1 << (2 * n_bits + i))
    return e


def merge_bitand_vals(a: int, b: int, n_bits: int = 8) -> int:
    return a | (b << n_bits) | ((a & b) << (2 * n_bits))


def bitand_index_to_entry(index: int, n_bits: int = 8) -> int:
    a = index & ((1 << n_bits) - 1)
    b = index >> n_bits
    return merge_bitand_vals(a, b, n_bits)


@dataclasses.dataclass
class BitAnd:
    """The looker's AND: commits the output, pulls the merged encoding."""

    in_a: Col
    in_b: Col
    output: Col
    merged: Col
    n_bits: int

    @staticmethod
    def build(t: TableBuilder, name: str, lookup_channel: int,
              in_a: Col, in_b: Col, n_bits: int = 8) -> "BitAnd":
        level = max(3, (max(1, n_bits) - 1).bit_length())
        output = t.add_committed(f"{name}.output", level, 0)
        merged = t.add_computed(
            f"{name}.merged",
            V(0) + V(1) * _c(1 << n_bits) + V(2) * _c(1 << (2 * n_bits)),
            [in_a, in_b, output])
        t.pull(lookup_channel, [merged])
        return BitAnd(in_a, in_b, output, merged, n_bits)

    def populate(self, tw, events: list) -> list:
        """events: [(a, b)]; returns a & b per row."""
        outs = [a & b for a, b in events]
        tw.set_column(self.output, outs)
        return outs


@dataclasses.dataclass
class BitAndLookup:
    """The AND table of 2^(2 n_bits) rows (the reference fixes n_bits = 8),
    built as the increment table is."""

    entries_ordered: Col
    entries_sorted: Col
    producer: LookupProducer
    n_bits: int

    @staticmethod
    def build(t: TableBuilder, lookup_channel: int, permutation_channel: int,
              n_multiplicity_bits: int, n_bits: int = 8) -> "BitAndLookup":
        t.require_fixed_size(2 * n_bits)
        ordered = t.add_structured("bitand_lookup", 5, bitand_merged_expr(n_bits))
        sorted_ = t.add_committed("entries_sorted", 5, 0)
        t.push(permutation_channel, [ordered])
        t.pull(permutation_channel, [sorted_])
        producer = LookupProducer.build(t, "bitand", lookup_channel, [sorted_],
                                        n_multiplicity_bits)
        return BitAndLookup(ordered, sorted_, producer, n_bits)

    def populate(self, tw, index_counts: list) -> None:
        assert len(index_counts) == 1 << (2 * self.n_bits)
        tw.set_column(self.entries_sorted,
                      [bitand_index_to_entry(i, self.n_bits)
                       for i, _ in index_counts])
        self.producer.populate(tw, [c for _, c in index_counts])

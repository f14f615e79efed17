"""Lookup tables over channels.

The port of `binius_tpu/m3/gadgets/lookup.py` (`LookupProducer`): the
lookup table pushes its value tuples with multiplicities the prover
chooses, bit-decomposed into one selector flush of weight 2^i per bit;
the lookers pull each value they read. The bits bound a multiplicity
below 2^n_multiplicity_bits.
"""

from __future__ import annotations

import dataclasses

from ..builder.table import TableBuilder


@dataclasses.dataclass
class LookupProducer:
    """n_multiplicity_bits committed B1 selector columns; bit i selects a
    push of the value columns with multiplicity 2^i."""

    multiplicity_bits: list

    @staticmethod
    def build(t: TableBuilder, name: str, channel_id: int, value_cols: list,
              n_multiplicity_bits: int) -> "LookupProducer":
        bits = []
        for i in range(n_multiplicity_bits):
            b = t.add_committed(f"{name}.multiplicity_bits[{i}]", 0, 0)
            t.push(channel_id, value_cols, multiplicity=1 << i, selector=b)
            bits.append(b)
        return LookupProducer(bits)

    def populate(self, tw, counts: list) -> None:
        """counts[r]: how many times row r's value tuple is read; each must
        fit in the multiplicity bits."""
        nb = len(self.multiplicity_bits)
        for c in counts:
            assert 0 <= c < (1 << nb), \
                f"count {c} exceeds maximum configured multiplicity 2^{nb}-1"
        for j, col in enumerate(self.multiplicity_bits):
            tw.set_column(col, [(int(c) >> j) & 1 for c in counts])

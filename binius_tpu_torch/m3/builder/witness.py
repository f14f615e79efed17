"""M3 witness index: host column buffers lowered to a device witness.

The port of `binius_tpu/m3/builder/witness.py` (numpy in place of the JAX
module's arrays): the user fills committed columns, with typed helpers
for bit-packed integers, and `to_core_witness` puts them on the device,
computes the exponent columns (`constraint_system.exp.make_exp_witnesses`)
and materializes every virtual column (shifted, computed, constant,
fixed, structured, packed, selected) from its oracle's definition. A table of any row
count (`WitnessIndex.with_sizes`) takes `size` rows of each column, or
its whole power-of-two capacity, and pads the rest with zero rows.
"""

from __future__ import annotations

import numpy as np

from ...constraint_system import witness as core_witness
from ...device import resolve
from ...fields import tower
from ...utils import tracing


class TableWitness:
    def __init__(self, table, log_rows: int, size: int = None):
        self.table = table
        self.log_rows = log_rows  # log2 of the power-of-two capacity
        self.size = (1 << log_rows) if size is None else size
        self.columns: dict = {}  # col index -> numpy array of 2^log_rows << vpr values
        self.words: dict = {}    # col index -> uint32 P1 words of a B1 column

    @property
    def n_rows(self) -> int:
        return 1 << self.log_rows

    def _pad(self, values: np.ndarray, per_row: int) -> np.ndarray:
        """`size` or all rows of `per_row` values; zero rows pad to the
        capacity."""
        full = self.n_rows * per_row
        assert values.shape[0] in (self.size * per_row, full), (values.shape, full)
        return np.pad(values, (0, full - values.shape[0])) if values.shape[0] < full else values

    def set_column(self, col, values) -> None:
        """A column's values (numpy or a list), 2^v values per row,
        row-major: `size` rows, zero-padded to the capacity, or all of
        them."""
        self.columns[col.index] = self._pad(np.asarray(values), 1 << col.log_values_per_row)
        self.words.pop(col.index, None)

    def set_packed_ints(self, col, row_values) -> None:
        """A B1 column of 2^v values per row from one integer per row: bit i
        of the integer is value i (LSB first)."""
        assert col.level == 0
        w = 1 << col.log_values_per_row
        assert w <= 64
        a = self._pad(np.asarray(row_values, dtype=np.uint64), 1)
        if w in (32, 64) and (self.n_rows * w) >> tower.P1_MIN_VARS:
            # one row's values are one or two whole words (little-endian):
            # keep the P1 words
            self.words[col.index] = (a.astype(np.uint32) if w == 32
                                     else np.ascontiguousarray(a).view(np.uint32))
            self.columns.pop(col.index, None)
            return
        bits = (a[:, None] >> np.arange(w, dtype=np.uint64)) & np.uint64(1)
        self.set_column(col, bits.reshape(-1).astype(np.uint32))

    def get_column(self, col) -> list:
        """The column's values, row-major, as ints."""
        if col.index in self.words:
            bits = np.unpackbits(self.words[col.index].view(np.uint8), bitorder="little")
            return [int(x) for x in bits]
        return [int(x) for x in self.columns[col.index]]

    def get_packed_ints(self, col) -> list:
        """One integer per row from a B1 column of 2^v values per row."""
        w = 1 << col.log_values_per_row
        if col.index in self.words:
            words = self.words[col.index]
            if w == 32:
                return [int(x) for x in words]
            return [int(x) for x in words.view(np.uint64)]
        vals = np.asarray(self.columns[col.index], dtype=np.uint64).reshape(self.n_rows, w)
        rows = np.bitwise_or.reduce(vals << np.arange(w, dtype=np.uint64), axis=1)
        return [int(x) for x in rows]


class WitnessIndex:
    def __init__(self, m3_system, table_log_rows: list):
        self.system = m3_system
        self.table_log_rows = list(table_log_rows)
        self.table_sizes = [1 << lr for lr in table_log_rows]
        self.tables = [TableWitness(t, lr) for t, lr in zip(m3_system.tables, table_log_rows)]

    @classmethod
    def with_sizes(cls, m3_system, table_sizes: list) -> "WitnessIndex":
        """Tables of any row count, each padded to its power-of-two capacity."""
        self = cls.__new__(cls)
        self.system = m3_system
        self.table_sizes = [int(s) for s in table_sizes]
        self.table_log_rows = [(s - 1).bit_length() for s in self.table_sizes]
        self.tables = [TableWitness(t, lr, s) for t, lr, s in
                       zip(m3_system.tables, self.table_log_rows, self.table_sizes)]
        return self

    def table(self, table_id: int) -> TableWitness:
        return self.tables[table_id]

    def to_core_witness(self, core_system, oracle_map, device=None) -> dict:
        """The core prover's witness on `device` (CUDA unless named):
        committed columns from the buffers, B1 ones bit-packed on the host
        where they are long enough, the exponent columns computed there and
        every virtual column materialized: a span "frontend/to_device" of
        `utils.tracing`."""
        with tracing.span("frontend/to_device", root=True):
            dev = resolve(device)
            witness: dict = {}
            for t, tw in zip(self.system.tables, self.tables):
                for cd in t.columns:
                    if cd.kind != "committed":
                        continue
                    oid = oracle_map[(t.table_id, cd.col.index)]
                    if cd.col.index in tw.words:
                        witness[oid] = (tower.P1, tower.from_numpy(5, tw.words[cd.col.index], dev))
                        continue
                    vals = tw.columns.get(cd.col.index)
                    assert vals is not None, f"column {cd.col.name} not filled"
                    level = cd.col.level
                    if (level == 0 and vals.shape[0] >= (1 << tower.P1_MIN_VARS)
                            and vals.shape[0] % 32 == 0):
                        b = (vals.astype(np.uint32) & 1).reshape(-1, 32)
                        words = np.bitwise_or.reduce(b << np.arange(32, dtype=np.uint32), axis=1)
                        witness[oid] = (tower.P1, tower.from_numpy(5, words, dev))
                    elif level <= 5:
                        witness[oid] = (level, tower.from_numpy(level, vals.astype(np.uint32), dev))
                    else:
                        witness[oid] = (level, tower.from_numpy(level, vals, dev))
            if core_system.exponents:
                # the exponent result columns, which the prover fills
                from ...constraint_system import exp as exp_mod
                exp_mod.make_exp_witnesses(core_system, witness)
            for oid in oracle_map.values():
                core_witness.materialize(core_system.oracles, witness, oid)
        return witness

"""F2-linear subspaces of binary tower fields (host, Python ints).

The port's copy of `binius_tpu/math/binary_subspace.py`: the domain of the
additive NTT.
"""

from __future__ import annotations

import dataclasses

from ..fields import scalar


@dataclasses.dataclass(frozen=True)
class BinarySubspace:
    """Subspace spanned by `basis` (field elements at tower `level`)."""

    level: int
    basis: tuple

    @staticmethod
    def with_dim(level: int, dim: int) -> "BinarySubspace":
        if dim > scalar.bits(level):
            raise ValueError("dim exceeds field size")
        return BinarySubspace(level, tuple(1 << i for i in range(dim)))

    @property
    def dim(self) -> int:
        return len(self.basis)

    def get(self, index: int) -> int:
        """Element #index: XOR of basis vectors selected by index bits."""
        out = 0
        for j in range(index.bit_length()):
            if (index >> j) & 1:
                out ^= self.basis[j]
        return out

    def iter_all(self):
        for i in range(1 << self.dim):
            yield self.get(i)

    def reduce_dim(self, dim: int) -> "BinarySubspace":
        if dim > self.dim:
            raise ValueError("cannot grow")
        return BinarySubspace(self.level, self.basis[:dim])

    def isomorphic(self, new_level: int) -> "BinarySubspace":
        """Reinterpret the basis at another tower level (identity embedding)."""
        if any(b >= (1 << scalar.bits(new_level)) for b in self.basis):
            raise ValueError("basis does not fit in target field")
        return BinarySubspace(new_level, self.basis)

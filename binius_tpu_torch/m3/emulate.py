"""M3 trace emulation: check a channel's balance before arithmetization.

The port of `binius_tpu/m3/emulate.py`: a `Channel` keeps the net
multiplicity of every value pushed or pulled; a balanced channel has
none left. A gadget's event loop runs against these plain channels
before its tables are built.
"""

from __future__ import annotations


class Channel:
    """A multiset of hashable values with net multiplicities."""

    def __init__(self):
        self.net_multiplicities: dict = {}

    def _add(self, val, delta: int) -> None:
        m = self.net_multiplicities.get(val, 0) + delta
        if m == 0:
            del self.net_multiplicities[val]
        else:
            self.net_multiplicities[val] = m

    def push(self, val) -> None:
        self._add(val, 1)

    def pull(self, val) -> None:
        self._add(val, -1)

    def is_balanced(self) -> bool:
        return not self.net_multiplicities

    def assert_balanced(self) -> None:
        if self.is_balanced():
            return
        lines = ["Channel is not balanced:"]
        for title, sign in (("Unbalanced pushes:", 1), ("Unbalanced pulls:", -1)):
            left = sorted(((v, sign * m) for v, m in self.net_multiplicities.items()
                           if sign * m > 0), key=lambda vm: repr(vm[0]))
            if left:
                lines.append(f"  {title}")
                lines.extend(f"    {m}: {v!r}" for v, m in left)
        raise AssertionError("\n".join(lines))

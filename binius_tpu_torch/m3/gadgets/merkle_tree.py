"""Merkle-tree inclusion proofs over the Grøstl-256 2-to-1 compression.

The port of `binius_tpu/m3/gadgets/merkle_tree.py`:

- a `nodes` channel carries tuples (root id, digest as 8 packed B32
  values, depth, index);
- three `NodesTable`s (pulling the left, the right or both children)
  each check one compression per row: the state x = left || right goes
  through the Grøstl P permutation and the parent is trunc(P(x) ^ x);
  each pushes the parent's tuple and pulls the children it needs;
- the child's depth is the parent's plus one through the `Incr` indexed
  lookup;
- a `RootTable` meets the depth-0 nodes with the public roots channel;
- the opened leaves and the roots are the statement's boundaries.

A digest travels the channel as 8 B32 values, value i packing state row i
of the state's right half, its bytes in the canonical tower basis (what
`add_packed` makes of the gadget's B8 columns).

`MerkleTreeTrace.generate` builds the tree's levels with the port's own
compression (`hash.groestl_cuda.pair_levels`: K6 on a CUDA device, its
plain version on the CPU), then walks the opened paths as the JAX
package's trace does. `merkle_inputs` and `merkle_system` make the seeded
instances of `examples/merkle_tree.py` that `chip_smoke.py` and the tests
prove.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from ...constraint_system.system import PUSH, Boundary
from ...device import resolve
from ...hash.groestl import bytes_to_state
from ...hash.groestl_cuda import pair_levels, split_layers
from ...math.arith import ArithExpr
from ...protocols import shift_ind
from ...utils import tracing
from ..builder.table import M3ConstraintSystem
from ..builder.witness import WitnessIndex
from .groestl import Permutation, _to_tower_table
from .indexed_lookup import Incr, IncrLookup

V = ArithExpr.var

LEFT = "left"
RIGHT = "right"
BOTH = "both"
ROOT_ID = 7  # the root id of `examples/merkle_tree.py`'s tree


def digest_to_channel_values(digest: bytes) -> list[int]:
    """A 32-byte digest -> its 8 packed-B32 channel values (tower basis,
    value i = state row i of the right state half)."""
    return [int(v) for v in _channel_values(np.frombuffer(digest, dtype=np.uint8)[None])[0]]


def _channel_values(digests: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 digests -> (n, 8) uint32 channel values."""
    t = _to_tower_table()[digests].astype(np.uint32).reshape(-1, 4, 8)
    return t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16) | (t[:, 3] << 24)


@dataclasses.dataclass(frozen=True)
class MerklePathEvent:
    """One compression on an opened path."""

    root_id: int
    parent_depth: int
    parent_index: int
    left: bytes    # the children's 32-byte digests (AES byte basis)
    right: bytes
    flush_left: bool
    flush_right: bool

    @property
    def variant(self) -> str:
        if self.flush_left and self.flush_right:
            return BOTH
        return LEFT if self.flush_left else RIGHT


class NodesTable:
    """One Merkle compression per row."""

    def __init__(self, m3, variant: str, nodes_channel: int, lookup_channel: int):
        self.variant = variant
        t = m3.add_table(f"merkle_nodes_{variant}")
        self.t = t
        self.root_id = t.add_committed("root_id", 5, 0)
        self.perm = Permutation.build(t, "perm", "P")
        state_in = self.perm.state_in
        state_out = self.perm.state_out

        self.left_cols = [t.add_committed(f"left{i}", 3, 2) for i in range(8)]
        self.right_cols = [t.add_committed(f"right{i}", 3, 2) for i in range(8)]
        self.parent_cols = [t.add_committed(f"parent{i}", 3, 2) for i in range(8)]

        left_packed = [t.add_packed(f"left_packed{i}", c) for i, c in enumerate(self.left_cols)]
        right_packed = [t.add_packed(f"right_packed{i}", c)
                        for i, c in enumerate(self.right_cols)]
        parent_packed = [t.add_packed(f"parent_packed{i}", c)
                         for i, c in enumerate(self.parent_cols)]
        state_packed = [t.add_packed(f"state_packed{i}", c) for i, c in enumerate(state_in)]

        # state_in = left || right, an equality of packed columns
        for i in range(8):
            t.assert_zero(f"state_split{i}", [state_packed[i], left_packed[i], right_packed[i]],
                          V(0) + V(1) + V(2) * ArithExpr.const(1 << 32, 6), group="state_split")

        # parent = columns 4..7 of P(x) xor right: trunc(P(x) ^ x)
        for i in range(8):
            sel = t.add_selected_block(f"pout{i}", state_out[i], 1, 2)
            t.assert_zero(f"parent_def{i}", [self.parent_cols[i], sel, self.right_cols[i]],
                          V(0) + V(1) + V(2), group="parent_def")

        self.parent_depth = t.add_committed("parent_depth", 3, 0)
        one = t.add_constant("one", 0, 1)
        self.incr = Incr.build(t, "depth_incr", lookup_channel, self.parent_depth, one)
        child_depth = self.incr.output

        # indices: left = 2 * parent, right = left + 1
        self.parent_index = t.add_committed("parent_index", 0, 5)
        left_index = t.add_shifted("left_index", self.parent_index, 1, 5,
                                   shift_ind.LOGICAL_LEFT)
        parent_index_packed = t.add_packed("parent_index_packed", self.parent_index)
        left_index_packed = t.add_packed("left_index_packed", left_index)
        right_index_packed = t.add_computed(
            "right_index_packed", V(0) + ArithExpr.const(1, 5), [left_index_packed])

        t.push(nodes_channel, [self.root_id, *parent_packed, self.parent_depth,
                               parent_index_packed])
        if variant in (LEFT, BOTH):
            t.pull(nodes_channel, [self.root_id, *left_packed, child_depth, left_index_packed])
        if variant in (RIGHT, BOTH):
            t.pull(nodes_channel, [self.root_id, *right_packed, child_depth,
                                   right_index_packed])

    def populate(self, tw, events: list) -> None:
        assert all(e.variant == self.variant for e in events)
        depth = np.array([e.parent_depth for e in events], dtype=np.uint32)
        tw.set_column(self.root_id, np.array([e.root_id for e in events], dtype=np.uint32))
        tw.set_column(self.parent_depth, depth)
        tw.set_packed_ints(self.parent_index,
                           np.array([e.parent_index for e in events], dtype=np.uint64))
        self.incr.populate(tw, [(int(d), 1) for d in depth])
        pairs = np.frombuffer(b"".join(e.left + e.right for e in events),
                              dtype=np.uint8).reshape(-1, 64)
        states = bytes_to_state(pairs)
        out = self.perm.populate(tw, states)
        # the parent's digest is the right half of P(x) ^ x
        parent = _to_tower_table()[out ^ states][:, :, 4:]
        tower_st = _to_tower_table()[states]
        for i in range(8):
            tw.set_column(self.left_cols[i], tower_st[:, i, :4].reshape(-1).astype(np.uint32))
            tw.set_column(self.right_cols[i], tower_st[:, i, 4:].reshape(-1).astype(np.uint32))
            tw.set_column(self.parent_cols[i], parent[:, i].reshape(-1).astype(np.uint32))


class RootTable:
    """The depth-0 nodes met with the public roots."""

    def __init__(self, m3, nodes_channel: int, roots_channel: int):
        t = m3.add_table("merkle_roots")
        self.t = t
        self.root_id = t.add_committed("root_id", 5, 0)
        self.digest = [t.add_committed(f"d{i}", 5, 0) for i in range(8)]
        zero = t.add_constant("zero", 5, 0)
        t.pull(roots_channel, [self.root_id, *self.digest])
        t.pull(nodes_channel, [self.root_id, *self.digest, zero, zero])

    def populate(self, tw, roots: list) -> None:
        """roots: [(root id, 32-byte digest)]."""
        tw.set_column(self.root_id, np.array([r for r, _ in roots], dtype=np.uint32))
        vals = _channel_values(np.frombuffer(b"".join(d for _, d in roots),
                                             dtype=np.uint8).reshape(-1, 32))
        for i in range(8):
            tw.set_column(self.digest[i], vals[:, i])


class MerkleTreeCS:
    """The inclusion-proof constraint system: the 512-row increment lookup
    table, the three nodes tables and the roots table, in that order."""

    def __init__(self, m3, n_multiplicity_bits: int = 8):
        self.nodes_channel = m3.add_channel()
        self.roots_channel = m3.add_channel()
        self.lookup_channel = m3.add_channel()
        self.perm_channel = m3.add_channel()
        incr_table = m3.add_table("incr_lookup")
        self.incr_lookup = IncrLookup.build(incr_table, self.lookup_channel, self.perm_channel,
                                            n_multiplicity_bits)
        self.tables = {v: NodesTable(m3, v, self.nodes_channel, self.lookup_channel)
                       for v in (LEFT, RIGHT, BOTH)}
        self.root_table = RootTable(m3, self.nodes_channel, self.roots_channel)

    def table_sizes(self, trace: "MerkleTreeTrace") -> list[int]:
        ev = trace.events_by_variant()
        return [1 << 9, len(ev[LEFT]), len(ev[RIGHT]), len(ev[BOTH]), len(trace.roots)]

    def fill_tables(self, trace: "MerkleTreeTrace", wi) -> None:
        ev = trace.events_by_variant()
        # the increment lookup counts the real node rows only (the padding
        # rows' pulls are masked by their StepDown selectors)
        counts = [0] * 512
        for v in (LEFT, RIGHT, BOTH):
            for e in ev[v]:
                counts[(1 << 8) | e.parent_depth] += 1
        self.incr_lookup.populate(wi.table(0), list(enumerate(counts)))
        dummy = MerklePathEvent(0, 0, 0, bytes(32), bytes(32), True, True)
        for k, v in enumerate((LEFT, RIGHT, BOTH)):
            tw = wi.table(1 + k)
            events = list(ev[v])
            # pad to the capacity by repeating the last row, which keeps
            # every row-wise constraint
            last = events[-1] if events else dataclasses.replace(
                dummy, flush_left=(v != RIGHT), flush_right=(v != LEFT))
            events += [last] * (tw.n_rows - len(events))
            self.tables[v].populate(tw, events)
        tw = wi.table(4)
        roots = list(trace.roots)
        roots += [roots[-1]] * (tw.n_rows - len(roots))
        self.root_table.populate(tw, roots)

    def make_boundaries(self, trace: "MerkleTreeTrace") -> list:
        out = []
        for root_id, depth, index, digest in trace.leaf_boundaries:
            out.append(Boundary(self.nodes_channel, PUSH,
                                (root_id, *digest_to_channel_values(digest), depth, index)))
        for root_id, digest in trace.roots:
            out.append(Boundary(self.roots_channel, PUSH,
                                (root_id, *digest_to_channel_values(digest))))
        return out


class MerkleTreeTrace:
    """The witness trace of a set of opened leaves."""

    def __init__(self):
        self.events: list[MerklePathEvent] = []
        self.leaf_boundaries: list = []  # (root id, depth, index, digest)
        self.roots: list = []            # (root id, digest)

    @staticmethod
    def generate(root_id: int, leaves, opened: list[int], device=None) -> "MerkleTreeTrace":
        """leaves: 2^D 32-byte digests ((2^D, 32) uint8, or a list of
        bytes); opened: the leaf indices to prove. The tree's levels are
        compressed on `device` (CUDA unless named)."""
        leaves = np.asarray([np.frombuffer(x, dtype=np.uint8) for x in leaves]
                            if isinstance(leaves, list) else leaves, dtype=np.uint8)
        n = leaves.shape[0]
        depth = (n - 1).bit_length()
        assert n == 1 << depth
        buf = torch.empty((2 * n - 1, 8), dtype=torch.int32, device=resolve(device))
        buf[:n] = torch.from_numpy(np.ascontiguousarray(leaves).view(np.int32)).to(buf.device)
        # levels[d] holds the nodes at depth (depth - d); the root is last
        tracing.count("readbacks")
        levels = split_layers(pair_levels(buf).cpu().numpy().view(np.uint8))
        needed = set()  # (depth, index) of the nodes pulled
        for li in sorted(set(opened)):
            d, i = depth, li
            while d > 0:
                needed.add((d, i))
                d, i = d - 1, i >> 1
        trace = MerkleTreeTrace()
        for pd, pi in sorted({(d - 1, i >> 1) for d, i in needed}):
            child = levels[depth - pd - 1]
            trace.events.append(MerklePathEvent(
                root_id, pd, pi, child[2 * pi].tobytes(), child[2 * pi + 1].tobytes(),
                flush_left=(pd + 1, 2 * pi) in needed,
                flush_right=(pd + 1, 2 * pi + 1) in needed))
        for li in sorted(set(opened)):
            trace.leaf_boundaries.append((root_id, depth, li, leaves[li].tobytes()))
        trace.roots.append((root_id, levels[depth][0].tobytes()))
        return trace

    def events_by_variant(self) -> dict:
        out = {LEFT: [], RIGHT: [], BOTH: []}
        for e in self.events:
            out[e.variant].append(e)
        return out


def merkle_inputs(log_leaves: int, n_opened: int, seed: int):
    """((2^log_leaves, 32) uint8 leaves, opened indices), drawn as
    `examples/merkle_tree.py` draws them: after `random.seed(seed)`, each
    leaf byte `random.getrandbits(8)`, then `random.sample` of the opened
    indices. getrandbits(8) is the top byte of one Mersenne Twister
    output, so numpy's MT19937, started from the same state, draws the
    leaves in bulk."""
    rng = random.Random(seed)
    n = 1 << log_leaves
    _, state, _ = rng.getstate()
    mt = np.random.MT19937()
    mt.state = {"bit_generator": "MT19937",
                "state": {"key": np.array(state[:624], dtype=np.uint32), "pos": state[624]}}
    leaves = (mt.random_raw(n * 32) >> 24).astype(np.uint8).reshape(n, 32)
    after = mt.state["state"]
    rng.setstate((3, tuple(int(k) for k in after["key"]) + (int(after["pos"]),), None))
    return leaves, rng.sample(range(n), n_opened)


def merkle_system(leaves, opened: list[int], device=None):
    """`examples/merkle_tree.py`'s system proving the opened leaves' paths
    in the tree of `leaves`, and its witness on `device` (CUDA unless
    named): returns (core system, witness, statement: boundaries and
    table sizes, trace). The increment lookup's multiplicity bits are the
    example's 8, or as many as the largest count of nodes at one depth
    needs."""
    with tracing.span("frontend/witness", root=True):
        trace = MerkleTreeTrace.generate(ROOT_ID, leaves, opened, device)
        most = max(np.bincount([e.parent_depth for e in trace.events]))
    with tracing.span("frontend/compile", root=True):
        m3 = M3ConstraintSystem()
        cs = MerkleTreeCS(m3, max(8, int(most).bit_length()))
        sizes = cs.table_sizes(trace)
        core, omap = m3.compile_sizes(sizes)
    with tracing.span("frontend/witness", root=True):
        wi = WitnessIndex.with_sizes(m3, sizes)
        cs.fill_tables(trace, wi)
        statement = {"boundaries": cs.make_boundaries(trace), "table_sizes": sizes}
    return core, wi.to_core_witness(core, omap, device), statement, trace

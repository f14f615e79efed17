"""The port's Merkle-tree inclusion gadget and `examples/merkle_tree.py`'s
system against the JAX package's, on the CPU.

`merkle_inputs` draws the example's leaves and opened indices. The
port's trace (its levels compressed by the plain version of K6) equals
the JAX `MerkleTreeTrace` at 16 leaves with 3 opened and at 64 leaves
with 8 opened (events, leaf boundaries, root). At the example's own
instance (16 leaves, 3 opened, seed 0, root id 7; table sizes [512, 0,
4, 2, 1]: the LEFT nodes table is empty) the packed and selected columns
lower as the JAX package's do (3,187 oracles: 102 packed, 24 projected;
the flushes, constraint sets, digest and statement equal), the witness
validates, and the port's proof has the
JAX package's length and sha256 (`chip_smoke.GOLDEN_CIRCUITS`, from
`scripts/port_golden_proof.py --circuit merkle_tree`; the JAX prover is
not run here), which the JAX verifier accepts. A wrong root and a wrong
sibling are rejected as the JAX package's gadget tests reject them.
Exact comparisons throughout."""

import collections
import dataclasses
import hashlib
import random

import pytest
import torch

import chip_smoke
from scripts import port_golden_proof
from binius_tpu.constraint_system import prove as jcsp
from binius_tpu.m3.gadgets import merkle_tree as jmerkle
from binius_tpu_torch import circuits
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system import system as cs_system
from binius_tpu_torch.m3.builder.table import M3ConstraintSystem
from binius_tpu_torch.m3.builder.witness import WitnessIndex
from binius_tpu_torch.m3.gadgets import merkle_tree

torch.set_num_threads(1)  # the suite's test processes share the cores

SIZE, SEED = 4, 0


@pytest.fixture(scope="module")
def port():
    return circuits.instance("merkle_tree", SIZE, SEED, "cpu")


@pytest.fixture(scope="module")
def reference():
    """The JAX package's system and statement of the example's instance
    (`scripts/port_golden_proof.merkle_tree` without its witness)."""
    from binius_tpu.m3.builder.table import M3ConstraintSystem as JM3

    random.seed(SEED)
    leaves = [bytes(random.getrandbits(8) for _ in range(32)) for _ in range(1 << SIZE)]
    opened = random.sample(range(1 << SIZE), port_golden_proof.MERKLE_OPENED[SIZE])
    trace = jmerkle.MerkleTreeTrace.generate(7, leaves, opened)
    m3 = JM3()
    cs = jmerkle.MerkleTreeCS(m3)
    sizes = cs.table_sizes(trace)
    core, _ = m3.compile_sizes(sizes)
    return core, {"boundaries": cs.make_boundaries(trace), "table_sizes": sizes}


def test_inputs_follow_the_example():
    leaves, opened = merkle_tree.merkle_inputs(SIZE, 3, SEED)
    random.seed(SEED)
    assert [bytes(x) for x in leaves] == [bytes(random.getrandbits(8) for _ in range(32))
                                          for _ in range(16)]
    assert opened == random.sample(range(16), 3) == [15, 11, 10]


@pytest.mark.parametrize("size", [4, 6])
def test_trace_equals_reference(size):
    leaves, opened = merkle_tree.merkle_inputs(size, circuits.merkle_opened(size), SEED)
    ours = merkle_tree.MerkleTreeTrace.generate(7, leaves, opened, "cpu")
    theirs = jmerkle.MerkleTreeTrace.generate(7, [bytes(x) for x in leaves], opened)
    assert [dataclasses.astuple(e) for e in ours.events] == \
        [dataclasses.astuple(e) for e in theirs.events]
    assert ours.leaf_boundaries == theirs.leaf_boundaries
    assert ours.roots == theirs.roots
    counts = collections.Counter(e.variant for e in ours.events)
    if size == 6:   # every nodes table has rows
        assert min(counts[v] for v in ("left", "right", "both")) > 0
    assert merkle_tree.digest_to_channel_values(ours.roots[0][1]) == \
        jmerkle.digest_to_channel_values(ours.roots[0][1])


def _oracles(core):
    return [(o.id, o.n_vars, o.tower_level, o.variant, o.name, o.inner, o.log_degree,
             o.proj_values, o.start_index) for o in core.oracles.oracles]


def test_system_equals_reference(port, reference):
    ours, theirs = port[0], reference[0]
    assert _oracles(ours) == _oracles(theirs)
    kinds = collections.Counter(o.variant for o in ours.oracles.oracles)
    assert (len(ours.oracles), kinds["packed"], kinds["projected"]) == (3187, 102, 24)
    assert [(f.channel_id, f.direction, f.oracle_ids, f.multiplicity, f.selector_ids)
            for f in ours.flushes] == [
        (f.channel_id, f.direction, f.oracle_ids, f.multiplicity, f.selector_ids)
        for f in theirs.flushes]
    assert [(c.n_vars, c.oracle_ids) for c in ours.constraint_sets] == [
        (c.n_vars, c.oracle_ids) for c in theirs.constraint_sets]
    assert ours.digest() == theirs.digest()
    assert port[2]["table_sizes"] == reference[1]["table_sizes"] == [512, 0, 4, 2, 1]
    assert [dataclasses.astuple(b) for b in port[2]["boundaries"]] == \
        [dataclasses.astuple(b) for b in reference[1]["boundaries"]]


def test_validate_witness(port):
    core, witness, stmt = port
    cs_system.validate_witness(core, dict(witness), stmt["boundaries"])


def _validate(trace):
    m3 = M3ConstraintSystem()
    cs = merkle_tree.MerkleTreeCS(m3, n_multiplicity_bits=4)
    sizes = cs.table_sizes(trace)
    core, omap = m3.compile_sizes(sizes)
    wi = WitnessIndex.with_sizes(m3, sizes)
    cs.fill_tables(trace, wi)
    cs_system.validate_witness(core, wi.to_core_witness(core, omap, "cpu"),
                               cs.make_boundaries(trace))


@pytest.mark.parametrize("fault", [None, "root", "sibling"])
def test_wrong_root_or_sibling_rejected(fault):
    leaves, _ = merkle_tree.merkle_inputs(2, 0, 191)
    trace = merkle_tree.MerkleTreeTrace.generate(7, leaves, [0], "cpu")
    if fault == "root":
        rid, digest = trace.roots[0]
        trace.roots[0] = (rid, bytes([digest[0] ^ 1]) + digest[1:])
    elif fault == "sibling":
        e = trace.events[0]
        trace.events[0] = dataclasses.replace(e, right=bytes([e.right[0] ^ 1]) + e.right[1:])
    if fault is None:
        _validate(trace)
        return
    with pytest.raises(ValueError):
        _validate(trace)


def test_proof_matches_golden(port, reference):
    core, witness, stmt = port
    proof = csp.prove(core, witness, device="cpu", **stmt)
    assert (SIZE, len(proof), hashlib.sha256(proof).hexdigest()) == \
        chip_smoke.GOLDEN_CIRCUITS["merkle_tree"]
    assert csp.peek_table_sizes(proof) == [512, 0, 4, 2, 1]
    jcsp.verify(reference[0], proof, **reference[1])

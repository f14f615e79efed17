"""The port's channels (flushes, boundaries, selectors, multiplicities,
non-zero claims) on the CPU against the JAX package's.

The channel systems of the JAX package's `tests/test_channels.py` and
`tests/test_lookup.py`, rebuilt from a seed in both packages
(`circuits.channel_system`, `scripts/port_golden_proof.channel_system`):
a permutation channel, boundaries, selector flushes, a lookup table
pushed with multiplicity bits, a non-zero claim. For each: the digest
equals the JAX package's, the port's proof has the JAX package's length
and sha256 (`chip_smoke.GOLDEN_CIRCUITS`, from `scripts/port_golden_proof.py`;
the JAX prover is not run here) and both verifiers accept it. Rejected
as the JAX package rejects them: an unbalanced channel and a deselected
row (the prover raises), wrong boundaries and a failed non-zero claim
(both verifiers raise), a zero flush product (the prover raises). The M3
front end's channels: the indexed lookup tables (`IncrLookup` with its
lookers, `BitAndLookup`) compile to the JAX package's oracles, flushes
and digest, and their witnesses validate. Exact comparisons throughout."""

import hashlib

import pytest

import chip_smoke
from scripts import port_golden_proof
from binius_tpu.constraint_system import prove as jcsp
from binius_tpu_torch import circuits
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.constraint_system import system as cs_system
from binius_tpu_torch.fields import tower


@pytest.mark.parametrize("name", circuits.CHANNEL_SYSTEMS)
def test_channel_system_proof_matches_golden(name):
    size, n_bytes, sha = chip_smoke.GOLDEN_CIRCUITS[name]
    core, witness, stmt = circuits.instance(name, size, 0, "cpu")
    jcore, _, jstmt = port_golden_proof.statement(name, size, 0)
    assert core.digest() == jcore.digest()
    cs_system.validate_witness(core, dict(witness), stmt.get("boundaries", ()))
    proof = csp.prove(core, witness, device="cpu", **stmt)
    assert (len(proof), hashlib.sha256(proof).hexdigest()) == (n_bytes, sha)
    csp.verify(core, proof, device="cpu", **stmt)
    jcsp.verify(jcore, proof, **jstmt)


def _flipped(witness: dict, oid: int, row: int, value: int) -> dict:
    lvl, data = witness[oid]
    data = data.clone()
    data[row] = value
    return {**witness, oid: (lvl, data)}


@pytest.mark.parametrize("name,oid,row", [("perm_channel", 1, 0), ("selector_flush", 1, 0),
                                          ("lookup_flush", 3, 2)])
def test_unbalanced_channel_rejected(name, oid, row):
    """A pulled value changed, a pushed row deselected, a read value
    changed: the channel no longer balances."""
    core, witness, stmt = circuits.instance(name, 3, 0, "cpu")
    value = 0 if name == "selector_flush" else tower.to_ints(5, witness[oid][1])[row] ^ 1
    bad = _flipped(witness, oid, row, value)
    with pytest.raises(ValueError, match="not balanced"):
        cs_system.validate_witness(core, dict(bad))
    with pytest.raises(ValueError, match="channel 0 is not balanced"):
        csp.prove(core, bad, device="cpu", **stmt)


def test_wrong_boundaries_rejected():
    core, witness, stmt = circuits.instance("boundary", 2, 0, "cpu")
    jcore, _, _ = port_golden_proof.statement("boundary", 2, 0)
    proof = csp.prove(core, witness, device="cpu", **stmt)
    from binius_tpu.constraint_system.system import Boundary as JBoundary
    from binius_tpu_torch.constraint_system.system import Boundary
    bad = [Boundary(b.channel_id, b.direction, (b.values[0] ^ 1,)) for b in stmt["boundaries"]]
    with pytest.raises(ValueError):
        csp.verify(core, proof, bad, device="cpu")
    with pytest.raises(ValueError):
        jcsp.verify(jcore, proof, [JBoundary(b.channel_id, b.direction, b.values) for b in bad])


def test_failed_non_zero_claim_rejected():
    core, witness, _ = circuits.instance("nonzero", 3, 0, "cpu")
    jcore, _, _ = port_golden_proof.statement("nonzero", 3, 0)
    bad = _flipped(witness, 0, 3, 0)
    with pytest.raises(ValueError, match="non-zero claim"):
        cs_system.validate_witness(core, dict(bad))
    proof = csp.prove(core, bad, device="cpu")
    with pytest.raises(ValueError, match="non-zero claim on oracle 0 failed"):
        csp.verify(core, proof, device="cpu")
    with pytest.raises(ValueError, match="non-zero claim on oracle 0 failed"):
        jcsp.verify(jcore, proof)


def test_zero_flush_product_rejected(monkeypatch):
    """alpha = 0 and a zero row make a flush's product zero; the prover
    refuses it (with a random alpha a zero row of alpha + beta * col has
    probability about 2^-128)."""
    core, witness, stmt = circuits.instance("perm_channel", 3, 0, "cpu")
    make = csp._make_flush_oracles
    monkeypatch.setattr(csp, "_make_flush_oracles", lambda s, a, b: make(s, 0, b))
    bad = _flipped(_flipped(witness, 0, 0, 0), 1, 5, 0)
    with pytest.raises(ValueError, match="zero flush product"):
        csp.prove(core, bad, device="cpu", **stmt)


def _compare_m3(ours, theirs):
    (core, omap), (jcore, jomap) = ours, theirs
    assert omap == jomap
    assert [(o.id, o.n_vars, o.tower_level, o.variant, o.name, o.inner)
            for o in core.oracles.oracles] == \
        [(o.id, o.n_vars, o.tower_level, o.variant, o.name, o.inner)
         for o in jcore.oracles.oracles]
    assert [(f.channel_id, f.direction, f.oracle_ids, f.multiplicity, f.selector_ids)
            for f in core.flushes] == \
        [(f.channel_id, f.direction, f.oracle_ids, f.multiplicity, f.selector_ids)
         for f in jcore.flushes]
    assert core.digest() == jcore.digest()


def _incr_system(pkg, n_rows: int):
    table, idx = pkg
    m3 = table.M3ConstraintSystem()
    lookup_ch, perm_ch = m3.add_channel(), m3.add_channel()
    looker = m3.add_table("incr_looker")
    incr = idx.IncrLooker.build(looker, "incr", lookup_ch)
    tl = m3.add_table("incr_table")
    producer = idx.IncrLookup.build(tl, lookup_ch, perm_ch, n_multiplicity_bits=8)
    return m3, m3.compile_sizes([n_rows, 512]), incr, producer


def test_incr_lookup_matches_reference():
    from binius_tpu.m3.builder import table as jtable
    from binius_tpu.m3.gadgets import indexed_lookup as jidx
    from binius_tpu_torch.m3.builder import table
    from binius_tpu_torch.m3.builder.witness import WitnessIndex
    from binius_tpu_torch.m3.gadgets import indexed_lookup as idx

    m3, ours, incr, producer = _incr_system((table, idx), 5)
    _compare_m3(ours, _incr_system((jtable, jidx), 5)[1])
    events = [(255, 1), (7, 0), (7, 1), (200, 0), (255, 1)]
    wi = WitnessIndex.with_sizes(m3, [5, 512])
    incr.populate(wi.table(0), events)
    counts = [0] * 512
    for i, c in events:
        counts[i | (c << 8)] += 1
    producer.populate(wi.table(1), [(i, counts[i]) for i in range(512)])
    core, omap = ours
    witness = wi.to_core_witness(core, omap, "cpu")
    cs_system.validate_witness(core, witness)
    assert tower.to_ints(0, witness[omap[(0, incr.incr.carry_out.index)]][1])[:5] == \
        [1, 0, 0, 0, 1]


def test_bitand_lookup_matches_reference():
    from binius_tpu.m3.builder import table as jtable
    from binius_tpu.m3.gadgets import indexed_lookup as jidx
    from binius_tpu_torch.m3.builder import table
    from binius_tpu_torch.m3.gadgets import indexed_lookup as idx

    def build(tbl, ix):
        m3 = tbl.M3ConstraintSystem()
        lookup_ch, perm_ch = m3.add_channel(), m3.add_channel()
        t = m3.add_table("looker")
        a, b = t.add_committed("a", 3, 0), t.add_committed("b", 3, 0)
        ix.BitAnd.build(t, "and", lookup_ch, a, b, n_bits=2)
        t.assert_nonzero(a)
        t.require_power_of_two_size()
        tl = m3.add_table("and_table")
        ix.BitAndLookup.build(tl, lookup_ch, perm_ch, 4, n_bits=2)
        return m3.compile_sizes([4, 16])

    _compare_m3(build(table, idx), build(jtable, jidx))

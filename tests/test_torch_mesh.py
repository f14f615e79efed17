"""The mesh: ranks spawned over gloo on the CPU (`parallel.distributed.run_ranks`,
free local ports, a timeout per spawn) against one process: the placement
rule, the collectives, `parallel/sharding.py`'s helpers, the sharded NTT at
worlds 2 and 4, and whole proofs at world 2 byte-equal to the one-device
proof and to the JAX package's pinned digests (`chip_smoke.GOLDEN_PROOF_16`;
`tests/test_torch_grouped.py`'s `GOLDEN_GROUPED_LOOKUP_EXP`, which that
file holds the one-device proof to)."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from binius_tpu_torch import circuits
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.fields import scalar, tower
from binius_tpu_torch.m3 import instances
from binius_tpu_torch.ntt.additive_ntt import AdditiveNTT, NTTDomain
from binius_tpu_torch.parallel import distributed
from binius_tpu_torch.parallel import mesh as mesh_mod
from binius_tpu_torch.parallel import sharding

torch.set_num_threads(1)
CPU = torch.device("cpu")
LEVEL = 7
SPAWN_TIMEOUT = 300.0
GOLDEN_GROUPED_LOOKUP_EXP = (120816,
                             "e0872180579ef3a25c67755a0a59b9a17a2c0ca23115a13787cefc7d776dbeec")
# (twiddle level, data level, log_x, log_y, coset, coset_bits, skip_rounds):
# B32 data with B32 twiddles on a batch K3's tile takes whole (2^15 per rank
# at world 2), B128 data with skipped rounds and a coset, B32 data over B8
# twiddles with X batched
NTT_CASES = [(5, 5, 0, 16, 0, 0, 0), (5, 7, 2, 8, 3, 2, 1), (3, 5, 1, 6, 1, 1, 0)]


def _rand(level: int, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2 ** 32, size=tower.elem_shape(level, (n,)), dtype=np.uint32)
    if level < 5:
        raw &= (1 << (1 << level)) - 1
    return tower.from_numpy(level, raw, CPU)


def _ntt_results() -> dict:
    """Each case's forward and inverse transform on this rank's block of a
    row-sharded batch, against the one-process transform."""
    mesh = mesh_mod.make_mesh()
    out = {}
    for ci, (tl, dl, log_x, log_y, coset, cb, skip) in enumerate(NTT_CASES):
        ntt = AdditiveNTT(NTTDomain.create(tl, log_y + cb))
        data = _rand(dl, 1 << (log_x + log_y), ci)
        for inverse in (False, True):
            fn = ntt.inverse if inverse else ntt.forward
            want = fn(data, dl, (log_x, log_y, 0), coset, cb, skip, device=CPU)
            got = fn(mesh_mod.put_row_sharded(mesh, dl, data, min_elems=1), dl,
                     (log_x, log_y, 0), coset, cb, skip, device=CPU)
            out[(ci, inverse)] = (isinstance(got, mesh_mod.RowShard)
                                  and torch.equal(got.local, mesh_mod.block_of(mesh, want))
                                  and torch.equal(mesh_mod.pull_local(got), want))
    return out


def _helper_results() -> dict:
    """The placement rule, the collectives and sharding.py's helpers on this
    rank, each against what one process computes from the whole tensors."""
    mesh = mesh_mod.make_mesh()
    r, n_dev = mesh.rank, mesh.size
    out = {"rank": r, "size": n_dev, "backend": mesh.backend,
           "multi_host": distributed.is_multi_host(),
           "fraction": distributed.local_device_fraction()}
    x = _rand(LEVEL, 2048, 1)
    words = _rand(0, 4096, 2)[:2048]                     # P1 words
    big = mesh_mod.put_row_sharded(mesh, LEVEL, x)
    out["placed"] = (isinstance(big, mesh_mod.RowShard) and big.shape == tuple(x.shape)
                     and torch.equal(big.local, x[r * 1024:(r + 1) * 1024]))
    out["small_replicated"] = torch.equal(mesh_mod.put_row_sharded(mesh, LEVEL, x[:1000]),
                                          x[:1000])
    out["min_elems"] = isinstance(mesh_mod.put_row_sharded(mesh, LEVEL, x[:64], min_elems=64),
                                  mesh_mod.RowShard)
    out["odd_replicated"] = not mesh_mod.is_mesh_sharded(
        mesh_mod.put_row_sharded(mesh, LEVEL, x[:1025], min_elems=1))
    out["p1_words"] = torch.equal(mesh_mod.put_row_sharded(mesh, tower.P1, words).local,
                                  words[r * 1024:(r + 1) * 1024])
    out["pull"] = torch.equal(mesh_mod.pull_local(big), x)
    strided = mesh_mod.to_strided(mesh, big.local, 0)
    out["strided"] = (torch.equal(strided.local, x[r::n_dev])
                      and torch.equal(mesh_mod.pull_local(strided), x))
    stack = x.reshape(4, 512, 4)
    out["axis_strided"] = torch.equal(
        mesh_mod.to_strided(mesh, mesh_mod.put_axis_sharded(mesh, stack, 1, 1).local, 1).local,
        stack[:, r::n_dev])
    out["xor"] = torch.equal(mesh_mod.xor_all_reduce(mesh, tower.xor_reduce(big.local, 0)),
                             tower.xor_reduce(x, 0))
    out["exchange"] = torch.equal(mesh_mod.exchange(mesh, big.local, r ^ 1),
                                  mesh_mod.block_of(mesh, x.roll(1024 * (1 - 2 * (r & 1)), 0)))
    # sharding.py: the bivariate round values, the low fold and the sum
    a, b = _rand(LEVEL, 128, 3), _rand(LEVEL, 128, 4)
    sa, sb = sharding.shard_multilinear(mesh, a), sharding.shard_multilinear(mesh, b)
    vals = tower.to_ints(LEVEL, sharding.sharded_bivariate_round_evals(mesh, 7)(sa, sb))
    ai, bi = tower.to_ints(LEVEL, a), tower.to_ints(LEVEL, b)
    want = []
    for pt in (0, 1, 2):
        acc = 0
        for j in range(64):
            av = ai[2 * j] ^ scalar.mul(LEVEL, ai[2 * j] ^ ai[2 * j + 1], pt)
            bv = bi[2 * j] ^ scalar.mul(LEVEL, bi[2 * j] ^ bi[2 * j + 1], pt)
            acc ^= scalar.mul(LEVEL, av, bv)
        want.append(acc)
    out["round_evals"] = vals == want
    ch = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321
    folded = sharding.sharded_fold_low(mesh, 7)(sa, tower.full(LEVEL, (), ch, CPU))
    fi = tower.to_ints(LEVEL, mesh_mod.pull_local(folded))
    local = 128 // n_dev
    out["fold_low"] = fi == [ai[s * local + 2 * j] ^ scalar.mul(
        LEVEL, ai[s * local + 2 * j] ^ ai[s * local + 2 * j + 1], ch)
        for s in range(n_dev) for j in range(local // 2)]
    out["xor_sum"] = torch.equal(sharding.sharded_xor_sum(mesh)(sa), tower.xor_reduce(a, 0))
    return out


def _proof_results() -> dict:
    """u32_add 2^16 and the lookups-and-exponentiation instance proven on
    the mesh: each proof's length and sha256, the sharded paths it took and
    the grouped provers it built (claims, whether sharded)."""
    from binius_tpu_torch.merkle import tree
    from binius_tpu_torch.ntt import sharded_ntt
    from binius_tpu_torch.protocols.sumcheck import prove as sc_prove

    calls = {"transform_sharded": 0, "_sharded_levels": 0, "grouped": []}
    for mod, name in ((sharded_ntt, "transform_sharded"), (tree, "_sharded_levels")):
        def counted(*a, _f=getattr(mod, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        setattr(mod, name, counted)

    class Spy(sc_prove.GroupedRegularSumcheckProver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            calls["grouped"].append((self.n_claims, self.mesh is not None))

    sc_prove.GroupedRegularSumcheckProver = Spy
    mesh = mesh_mod.make_mesh()
    out = {}
    core, witness, _ = circuits.instance("u32_add", 16, 0, CPU)
    proof = csp.prove(core, witness, mesh=mesh)
    out["u32_add"] = (len(proof), hashlib.sha256(proof).hexdigest(), proof if mesh.rank == 0
                      else None, dict(calls, grouped=list(calls["grouped"])))
    for k in ("transform_sharded", "_sharded_levels"):
        calls[k] = 0
    core, witness = instances.grouped_lookup_exp_instance(17, device=CPU)
    proof = csp.prove(core, witness, mesh=mesh, group_claims=True, min_shard_elems=1)
    out["grouped_lookup_exp"] = (len(proof), hashlib.sha256(proof).hexdigest(),
                                 proof if mesh.rank == 0 else None, calls)
    return out


def _golden_8() -> tuple:
    """The golden 8-row proof with every column sharded that divides: at
    world 2 its claim runs sharded and stage 2 gathers its folded rows (too
    few to lay out strided), at world 4 the claim is gathered whole."""
    core, witness = chip_smoke.golden_system(CPU)
    proof = csp.prove(core, witness, mesh=mesh_mod.make_mesh(), min_shard_elems=1)
    return len(proof), hashlib.sha256(proof).hexdigest()


def _world2() -> dict:
    torch.set_num_threads(1)
    return {"helpers": _helper_results(), "ntt": _ntt_results(), "proofs": _proof_results(),
            "golden_8": _golden_8()}


def _world4() -> dict:
    torch.set_num_threads(1)
    return {"ntt": _ntt_results(), "golden_8": _golden_8()}


def _fail() -> None:
    raise ValueError("this rank fails")


@pytest.fixture(scope="module")
def world2():
    return distributed.run_ranks(_world2, 2, device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def world4():
    return distributed.run_ranks(_world4, 4, device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("key", ["placed", "small_replicated", "min_elems", "odd_replicated",
                                 "p1_words"])
def test_placement_rule(world2, key):
    """Rows shard in contiguous blocks when at least max(min_elems, ranks)
    and divisible by the ranks, and replicate otherwise."""
    assert all(r["helpers"][key] for r in world2)


@pytest.mark.parametrize("key", ["pull", "strided", "axis_strided", "xor", "exchange"])
def test_collectives(world2, key):
    """pull_local, the strided relayout, the XOR all-reduce and the pairwise
    exchange give the one-process tensors."""
    assert all(r["helpers"][key] for r in world2)


@pytest.mark.parametrize("key", ["round_evals", "fold_low", "xor_sum"])
def test_sharding_helpers(world2, key):
    assert all(r["helpers"][key] for r in world2)


def test_process_group(world2):
    """Two ranks on the CPU: gloo, one host, both ranks local."""
    assert [(r["helpers"]["rank"], r["helpers"]["size"]) for r in world2] == [(0, 2), (1, 2)]
    assert all(r["helpers"]["backend"] == "gloo" and not r["helpers"]["multi_host"]
               and r["helpers"]["fraction"] == (2, 2) for r in world2)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ntt(world, request):
    """`transform_sharded` (cross stages by exchange, local stages through
    the port's NTT) is bit-equal to the one-device transform, forward and
    inverse, with cosets and skipped rounds."""
    ranks = request.getfixturevalue(f"world{world}")
    assert len(ranks) == world
    for r in ranks:
        assert r["ntt"] == {(ci, inv): True for ci in range(len(NTT_CASES))
                            for inv in (False, True)}


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_proof_golden_8(world, request):
    """The golden 8-row proof at worlds 2 and 4: every rank gives its bytes."""
    ranks = request.getfixturevalue(f"world{world}")
    assert all(r["golden_8"] == chip_smoke.GOLDEN_PROOF_8 for r in ranks)


def test_mesh_proof_u32_add(world2):
    """u32_add 2^16 at world 2: both ranks give the one-device proof (the
    JAX package's digest), through the sharded commit; it verifies."""
    n0, sha0, proof, calls = world2[0]["proofs"]["u32_add"]
    assert all(r["proofs"]["u32_add"][:2] == (n0, sha0) for r in world2)
    assert (n0, sha0) == chip_smoke.GOLDEN_PROOF_16
    assert calls["transform_sharded"] == 1 and calls["_sharded_levels"] == 1
    core, _, _ = circuits.instance("u32_add", 16, 0, CPU)
    csp.verify(core, proof, device=CPU)


def test_mesh_proof_grouped_lookup_exp(world2):
    """The lookups-and-exponentiation instance at world 2, its columns
    sharded from one row up: both ranks give the one-device proof (the JAX
    package's digest) with its two same-structure claims one sharded group;
    it verifies."""
    n0, sha0, proof, calls = world2[0]["proofs"]["grouped_lookup_exp"]
    assert all(r["proofs"]["grouped_lookup_exp"][:2] == (n0, sha0) for r in world2)
    assert (n0, sha0) == GOLDEN_GROUPED_LOOKUP_EXP
    assert any(n >= 2 and sharded for n, sharded in calls["grouped"])
    core, _ = instances.grouped_lookup_exp_instance(17, device=CPU)
    csp.verify(core, proof, device=CPU)


def test_run_ranks_reports_a_failed_rank():
    """A rank that raises fails the call, and no rank outlives it."""
    with pytest.raises(RuntimeError, match="this rank fails"):
        distributed.run_ranks(_fail, 1, device="cpu", timeout=SPAWN_TIMEOUT)

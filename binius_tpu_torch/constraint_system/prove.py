"""Top-level constraint-system prover and verifier.

The port of `binius_tpu/constraint_system/prove.py`. Proving runs these
phases on one device (CUDA unless the caller names another), or on every
rank of a mesh (`prove(..., mesh=)`, see its docstring):

  1. setup: observe the constraint-system digest;
  2. commit: pack the committed columns, RS-encode and Merkle-commit them,
     the root to the transcript;
  3. exp: the exponentiation phase, the GKR walk of every exponent's
     circuit (`exp.prove_phase`; nothing for a system with no exponents);
     its layer witnesses and result columns are computed before the
     commit;
  4. gpa: the channels and non-zero claims, through the GKR grand-product
     argument (`protocols.gkr_gpa`): alpha and beta sampled, one flush
     oracle per flush (alpha + sum beta^i col_i, or 1 + sel * (1 + that)
     with selectors), every instance's product written, each channel's
     balance against its boundaries checked, the product trees walked
     down to evaluation claims (nothing for a system with no flush and no
     non-zero claim);
  5. zerocheck over all constraint sets: the univariate-skip reduction, or
     the eq-indicator sumcheck when no round is skipped;
  6. evalcheck: reduce the virtual oracles' claims to committed ones;
  7. ring switch: committed small-field claims -> PIOP sumcheck claims;
  8. PIOP: the sumcheck interleaved with FRI, and the query phase.

The boundaries are observed after the digest, and the table sizes, where
given, are the proof's first message. `last_phase_times` holds the last
proof's seconds per phase, its "total", and the seconds of every span of
`utils.tracing` closed since the proof before, under its path ("frontend/
compile", "evalcheck/walk", "zerocheck/stage2/sumcheck.round"); keys
without "/" are the phases and "total". `last_phase_sizes` holds its bytes
per phase (from the commit on: the table sizes' message is in none).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ..device import resolve
from ..fields import scalar, tower
from ..math.arith import ArithExpr, CompositionPoly
from ..parallel import mesh as mesh_mod
from ..protocols import evalcheck, gkr_gpa, piop, ring_switch
from ..protocols import fri as fri_mod
from ..protocols.sumcheck import univariate_zerocheck as uzc
from ..protocols.sumcheck import zerocheck as zc
from ..protocols.sumcheck.common import LEVEL
from ..transcript.transcript import ProverTranscript, VerifierTranscript
from ..utils import tracing
from . import exp as exp_mod
from . import witness as witness_mod
from .system import PUSH, ConstraintSystem

SECURITY_BITS = 100

last_phase_times: dict = {}
last_phase_sizes: dict = {}

class _PhaseTimer:
    """Proof bytes per phase, and each phase a root span of `utils.tracing`
    (its seconds in `last_phase_times`, its profiler range "prove.<phase>",
    which `scripts/profile_opening.py --proof` and the benchmark's device
    trace see); on a CUDA device each phase ends with a synchronize inside
    its span, so a phase's time holds its device work. A phase's bytes are
    what it wrote to the transcript's tape. A phase entered twice (exp: its
    witnesses before the commit, its GKR walk after) sums both."""

    def __init__(self, device: torch.device, transcript: ProverTranscript):
        self.device = device
        self.transcript = transcript
        self.sizes: dict = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        mark = len(self.transcript._tape)
        with tracing.span(name, range=f"prove.{name}", root=True):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.sizes[name] = self.sizes.get(name, 0) + len(self.transcript._tape) - mark

    def done(self) -> None:
        """Publish the spans closed since the last proof, this proof's
        phases among them, and the total, as `last_phase_times`."""
        times = tracing.publish()
        times["total"] = time.perf_counter() - self._t0
        for last, now in ((last_phase_times, times), (last_phase_sizes, self.sizes)):
            last.clear()
            last.update(now)


@dataclasses.dataclass
class CommitLayout:
    """The committed oracles in the PIOP batch's order."""

    oracle_ids: list       # committed oracle ids, ascending by packed n_vars
    packed_n_vars: list
    commit_meta: piop.CommitMeta
    oracle_to_idx: dict

    @staticmethod
    def from_system(system: ConstraintSystem) -> "CommitLayout":
        keyed = []
        for oid in system.oracles.committed_ids():
            o = system.oracles[oid]
            # tiny columns (n_vars + level < 7) repeat-pack into one B128 element
            keyed.append((max(0, o.n_vars + o.tower_level - 7), oid))
        keyed.sort()
        ordered = [oid for _, oid in keyed]
        packed_vars = [p for p, _ in keyed]
        counts = [0] * (max(packed_vars, default=0) + 1)
        for p in packed_vars:
            counts[p] += 1
        return CommitLayout(ordered, packed_vars, piop.CommitMeta(tuple(counts)),
                            {oid: i for i, oid in enumerate(ordered)})


def make_fri_params(commit_meta: piop.CommitMeta, log_inv_rate: int) -> fri_mod.FRIParams:
    return piop.make_commit_params(commit_meta, SECURITY_BITS, log_inv_rate)


def _zerocheck_claims(system: ConstraintSystem, ascending: bool = False):
    """(constraint sets sorted by n_vars, their zerocheck claims)."""
    key = (lambda s: s.n_vars) if ascending else (lambda s: -s.n_vars)
    sets = sorted(system.constraint_sets, key=key)
    claims = [zc.ZerocheckClaim(s.n_vars, len(s.oracle_ids),
                                tuple(CompositionPoly(e, len(s.oracle_ids))
                                      for e in s.zero_constraints))
              for s in sets]
    return sets, claims


def _zerocheck_skip(system: ConstraintSystem) -> int:
    """The univariate-skip round count (0: the eq-indicator zerocheck)."""
    if not system.constraint_sets:
        return 0
    _, claims = _zerocheck_claims(system, ascending=True)
    return uzc.compute_skip_rounds(claims)


def _to_evalcheck_claims(sets, out, order_high: bool):
    """Eq-indicator zerocheck outputs -> evalcheck claims."""
    from ..protocols.sumcheck import verify as sc_verify
    n_rounds = sets[0].n_vars if sets else 0
    claims = []
    for s, evals in zip(sets, out.multilinear_evals):
        pt = tuple(sc_verify.claim_point(n_rounds, s.n_vars, out.challenges, order_high))
        for oid, ev in zip(s.oracle_ids, evals[1:]):   # without the eq multilinear
            claims.append(evalcheck.EvalcheckClaim(oid, pt, ev))
    return claims


def _skip_evalcheck_claims(sets, out):
    return [evalcheck.EvalcheckClaim(oid, tuple(pt), ev)
            for s, evs, pt in zip(sets, out.multilinear_evals, out.eval_points)
            for oid, ev in zip(s.oracle_ids, evs)]


def _observe_setup(transcript, system: ConstraintSystem, boundaries) -> None:
    transcript.observe().write_bytes(system.digest())
    w = transcript.observe()
    for b in boundaries:
        w.write_u64(b.channel_id)
        w.write_bytes(b.direction.encode())
        w.write_u64(b.multiplicity)
        w.write_scalars(LEVEL, list(b.values))


def _working_copy(system: ConstraintSystem) -> ConstraintSystem:
    """The system with its own oracle set: the flush oracles join it while
    proving or verifying."""
    return ConstraintSystem(system.oracles.clone(), system.constraint_sets, system.flushes,
                            system.n_channels, system.non_zero_claims, system.exponents)


def _make_flush_oracles(system: ConstraintSystem, alpha: int, beta: int):
    """The flush oracles, made alike on both sides: alpha + sum beta^i
    col_i as a linear combination, or with selectors the composite
    1 + sel * (1 + alpha + sum beta^i col_i), so that a deselected row
    puts 1 into the product. The flushes are stable-sorted by channel id
    first. Returns [(flush, oracle id)]."""
    out = []
    for f in sorted(system.flushes, key=lambda f: f.channel_id):
        n_vars = system.oracles[f.oracle_ids[0]].n_vars
        coeff = beta
        terms = []
        for oid in f.oracle_ids:
            assert system.oracles[oid].n_vars == n_vars
            terms.append((oid, coeff))
            coeff = scalar.mul(LEVEL, coeff, beta)
        if not f.selector_ids:
            oid = system.oracles.add_linear_combination(n_vars, terms, alpha, f"flush_{len(out)}")
        else:
            ns = len(f.selector_ids)
            mix = ArithExpr.const(alpha ^ 1, 7)
            for i, (_, c) in enumerate(terms):
                mix = mix + ArithExpr.const(c, 7) * ArithExpr.var(i + ns)
            sel = ArithExpr.var(0)
            for k in range(1, ns):
                sel = sel * ArithExpr.var(k)
            oid = system.oracles.add_composite(n_vars, [*f.selector_ids, *f.oracle_ids],
                                               ArithExpr.const(1) + sel * mix,
                                               f"flush_{len(out)}")
        out.append((f, oid))
    return out


def _boundary_value(b, alpha: int, beta: int) -> int:
    acc = alpha
    coeff = beta
    for v in b.values:
        acc ^= scalar.mul(LEVEL, coeff, v)
        coeff = scalar.mul(LEVEL, coeff, beta)
    return acc


def _check_channel_balance(system, boundaries, flush_products, alpha, beta) -> None:
    """Per channel, the pushes' products (each to its multiplicity) against
    the pulls', the boundaries' values included."""
    lhs = [1] * system.n_channels
    rhs = [1] * system.n_channels
    for (f, _), p in flush_products:
        side = lhs if f.direction == PUSH else rhs
        side[f.channel_id] = scalar.mul(LEVEL, side[f.channel_id],
                                        scalar.pow(LEVEL, p, f.multiplicity))
    for b in boundaries:
        v = scalar.pow(LEVEL, _boundary_value(b, alpha, beta), b.multiplicity)
        side = lhs if b.direction == PUSH else rhs
        side[b.channel_id] = scalar.mul(LEVEL, side[b.channel_id], v)
    for c in range(system.n_channels):
        if lhs[c] != rhs[c]:
            raise ValueError(f"channel {c} is not balanced")


def _gpa_instances(system: ConstraintSystem, flush_oracles):
    """[(oracle id, "flush" | "nonzero", flush)], descending by n_vars,
    flushes before non-zero claims at equal size."""
    inst = [(oid, "flush", f) for f, oid in flush_oracles]
    inst += [(nz.oracle_id, "nonzero", None) for nz in system.non_zero_claims]
    inst.sort(key=lambda t: -system.oracles[t[0]].n_vars)
    return inst


def _gpa_prove(system, witness, boundaries, transcript) -> list:
    """The grand-product phase's prover; returns its evaluation claims.
    The inputs of each size group are one B128 stack
    (`witness.materialize_stack`, not cached) and one product tree; the
    products cross to the host in one copy."""
    if not (system.flushes or system.non_zero_claims):
        return []
    alpha = transcript.sample_scalar(LEVEL)
    beta = transcript.sample_scalar(LEVEL)
    instances = _gpa_instances(system, _make_flush_oracles(system, alpha, beta))
    groups: list = []   # [(n_vars, oracle ids)], runs of equal n_vars
    for oid, _, _ in instances:
        n = system.oracles[oid].n_vars
        if groups and groups[-1][0] == n:
            groups[-1][1].append(oid)
        else:
            groups.append((n, [oid]))
    wits = [gkr_gpa.GrandProductWitness.compute(
        n, witness_mod.materialize_stack(system.oracles, witness, oids)) for n, oids in groups]
    products = tower.to_ints(LEVEL, torch.cat([w.layers[0][:, 0] for w in wits]))
    claims, flush_products = [], []
    msg = transcript.message()
    for (oid, kind, f), p in zip(instances, products):
        if kind == "flush" and p == 0:
            raise ValueError("zero flush product (table row collides with challenge)")
        msg.write_scalar(LEVEL, p)
        claims.append(gkr_gpa.GrandProductClaim(system.oracles[oid].n_vars, p))
        if kind == "flush":
            flush_products.append(((f, oid), p))
    _check_channel_balance(system, boundaries, flush_products, alpha, beta)
    out = gkr_gpa.batch_prove(claims, wits, transcript)
    return [evalcheck.EvalcheckClaim(oid, tuple(pt), ev)
            for (oid, _, _), pt, ev in zip(instances, out.eval_points, out.evals)]


def _gpa_verify(system, boundaries, transcript) -> list:
    if not (system.flushes or system.non_zero_claims):
        return []
    alpha = transcript.sample_scalar(LEVEL)
    beta = transcript.sample_scalar(LEVEL)
    instances = _gpa_instances(system, _make_flush_oracles(system, alpha, beta))
    r = transcript.message()
    claims, flush_products = [], []
    for oid, kind, f in instances:
        p = r.read_scalar(LEVEL)
        if kind == "nonzero" and p == 0:
            raise ValueError(f"non-zero claim on oracle {oid} failed")
        claims.append(gkr_gpa.GrandProductClaim(system.oracles[oid].n_vars, p))
        if kind == "flush":
            flush_products.append(((f, oid), p))
    _check_channel_balance(system, boundaries, flush_products, alpha, beta)
    out = gkr_gpa.batch_verify(claims, transcript)
    return [evalcheck.EvalcheckClaim(oid, tuple(pt), ev)
            for (oid, _, _), pt, ev in zip(instances, out.eval_points, out.evals)]


def _ring_switch_claims(system, layout, committed_claims):
    keyed = []
    for c in committed_claims:
        o = system.oracles[c.oracle_id]
        idx = layout.oracle_to_idx[c.oracle_id]
        pt = tuple(c.point)
        kappa = 7 - o.tower_level
        if len(pt) < kappa:
            # tiny column: zeros pad the point to kappa, as the repeat-packed element
            pt = pt + (0,) * (kappa - len(pt))
        keyed.append((layout.packed_n_vars[idx], idx,
                      ring_switch.RingSwitchEvalClaim(idx, o.tower_level, pt, c.eval)))
    keyed.sort(key=lambda t: (t[0], t[1]))
    return [k[2] for k in keyed]


def prove(system: ConstraintSystem, witness: dict, boundaries: list = (),
          log_inv_rate: int = 1, table_sizes: list = None, device=None, mesh=None,
          group_claims: bool | None = None, min_shard_elems: int | None = None) -> bytes:
    """witness: oracle id -> (level, tensor) for the committed and virtual
    oracles (`m3.builder.witness.WitnessIndex.to_core_witness`). Runs on
    CUDA unless `device` names another; the witness moves there.
    `boundaries`: the statement's channel boundaries; `table_sizes`: the
    M3 tables' row counts, written as the proof's first message (the M3
    verifier reads them back, `peek_table_sizes`).

    `group_claims`: prove same-structure zerocheck claims as one grouped
    prover in stage 2 (None: on CUDA, off on the CPU); the bytes are the
    same either way.

    `mesh` (`parallel.mesh.make_mesh()`, every rank calling `prove` with the
    same arguments): the witness columns are placed with
    `mesh.put_row_sharded` (columns of fewer than `min_shard_elems` rows,
    default `mesh.MIN_SHARD_ELEMS`, replicate), the proof runs on the mesh's
    device, and every rank returns the proof, byte-equal to the one-device
    proof. Sharded: the commit's Reed-Solomon encoding (`ntt.sharded_ntt`)
    and Merkle leaves and subtrees, and the zerocheck (stage 1, the
    skipped fold, stage 2 until log2 N variables are left, stage 3's
    projection). The other phases read the columns gathered once
    (`mesh.pull_local`) and run whole on every rank.

    A proof that raises publishes nothing: `utils.tracing.discard()` throws
    away its spans and counts, its front end's too."""
    try:
        return _prove(system, witness, boundaries, log_inv_rate, table_sizes, device, mesh,
                      group_claims, min_shard_elems)
    except BaseException:
        tracing.discard()
        raise


def _prove(system, witness, boundaries, log_inv_rate, table_sizes, device, mesh,
           group_claims, min_shard_elems) -> bytes:
    dev = mesh.device if mesh is not None else resolve(device)
    transcript = ProverTranscript()
    timer = _PhaseTimer(dev, transcript)
    _observe_setup(transcript, system, boundaries)
    if table_sizes is not None:
        w = transcript.message()
        w.write_u64(len(table_sizes))
        for size in table_sizes:
            w.write_u64(size)
    system = _working_copy(system)
    witness = {oid: (lvl, d.to(dev)) for oid, (lvl, d) in witness.items()}
    placed = witness
    if mesh is not None and mesh.size > 1:
        min_elems = mesh_mod.MIN_SHARD_ELEMS if min_shard_elems is None else min_shard_elems
        placed = {oid: (lvl, mesh_mod.put_row_sharded(mesh, lvl, d, min_elems))
                  for oid, (lvl, d) in sorted(witness.items())}
        # the gathered columns that the phases run whole on every rank read
        witness = {oid: (lvl, mesh_mod.pull_local(d)) for oid, (lvl, d) in placed.items()}

    with timer.phase("exp"):   # the layer witnesses and result columns, which the commit needs
        exp_witnesses = exp_mod.make_exp_witnesses(system, witness)
    with timer.phase("commit"):
        layout = CommitLayout.from_system(system)
        fri_params = make_fri_params(layout.commit_meta, log_inv_rate)
        packed_mles = []
        for oid, packed_vars in zip(layout.oracle_ids, layout.packed_n_vars):
            o = system.oracles[oid]
            level, data = witness[oid]
            if level == tower.P1:
                # bit-packed B1 words are the B128 limb layout: packing is a view
                packed, pv = data.reshape(-1, tower.n_limbs(LEVEL)), o.n_vars - 7
            else:
                assert level == o.tower_level
                packed, pv = piop.pack_multilinear(level, data, o.n_vars)
            assert pv == packed_vars
            packed_mles.append((packed, pv))
        codeword, tree, _ = piop.commit(fri_params, layout.commit_meta, packed_mles, dev,
                                        mesh if mesh is not None and mesh.size > 1 else None)
        transcript.message().write_bytes(tree.root)

    with timer.phase("exp"):
        ec_exp = exp_mod.prove_phase(system, witness, exp_witnesses, transcript)

    with timer.phase("gpa"):
        ec_gpa = _gpa_prove(system, witness, boundaries, transcript)

    with timer.phase("zerocheck"):
        with tracing.span("claims"):
            skip = _zerocheck_skip(system)
            sets, claims = _zerocheck_claims(system, ascending=skip > 0)
        if skip > 0:
            out = uzc.batch_prove(claims, [[placed[oid] for oid in s.oracle_ids] for s in sets],
                                  transcript, skip, group_claims=group_claims)
            ec_claims = _skip_evalcheck_claims(sets, out)
        else:
            out = zc.batch_prove(claims, [[tower.resolve_p1(*witness[oid])
                                           for oid in s.oracle_ids] for s in sets],
                                 transcript, order_high=False)
            ec_claims = _to_evalcheck_claims(sets, out, False)
        ec_claims += ec_gpa + ec_exp

    with timer.phase("evalcheck"):
        committed_claims = evalcheck.prove(system.oracles, witness, ec_claims, transcript)

    with timer.phase("ring_switch"):
        rs_claims = _ring_switch_claims(system, layout, committed_claims)
        reduced = ring_switch.prove(rs_claims, [witness[oid] for oid in layout.oracle_ids],
                                    transcript, dev)

    with timer.phase("piop"):
        piop.prove(fri_params, layout.commit_meta, codeword, tree, packed_mles,
                   reduced.transparent_mles, reduced.sumcheck_claims, transcript, dev)
        proof = transcript.finalize()
    timer.done()
    return proof


def peek_table_sizes(proof: bytes) -> list[int]:
    """The table sizes a proof made with `table_sizes` starts with."""
    r = VerifierTranscript(proof).message()
    return [r.read_u64() for _ in range(r.read_u64())]


def verify(system: ConstraintSystem, proof: bytes, boundaries: list = (),
           log_inv_rate: int = 1, table_sizes: list = None, device=None) -> None:
    """Raises ValueError (or EOFError on a short proof) unless the proof
    verifies. Host code, but for the ring switch's transparents, which
    evaluate batched on `device` (CUDA unless named)."""
    transcript = VerifierTranscript(proof)
    _observe_setup(transcript, system, boundaries)
    if table_sizes is not None:
        r = transcript.message()
        if [r.read_u64() for _ in range(r.read_u64())] != list(table_sizes):
            raise ValueError("table sizes in proof do not match the instance")
    system = _working_copy(system)
    layout = CommitLayout.from_system(system)
    fri_params = make_fri_params(layout.commit_meta, log_inv_rate)
    commitment = transcript.message().read_bytes(32)
    ec_exp = exp_mod.verify_phase(system, transcript)
    ec_gpa = _gpa_verify(system, boundaries, transcript)

    skip = _zerocheck_skip(system)
    if skip > 0:
        sets, claims = _zerocheck_claims(system, ascending=True)
        ec_claims = _skip_evalcheck_claims(sets, uzc.batch_verify(claims, transcript, skip))
    else:
        sets, claims = _zerocheck_claims(system)
        ec_claims = _to_evalcheck_claims(
            sets, zc.batch_verify(claims, transcript, order_high=False), False)
    ec_claims += ec_gpa + ec_exp

    committed_claims = evalcheck.verify(system.oracles, ec_claims, transcript)
    rs_claims = _ring_switch_claims(system, layout, committed_claims)
    reduced = ring_switch.verify(rs_claims, transcript, device)
    piop.verify(fri_params, layout.commit_meta, commitment, reduced.transparent_mles,
                reduced.sumcheck_claims, transcript)
    transcript.finalize()

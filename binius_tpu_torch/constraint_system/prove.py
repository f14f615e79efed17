"""Top-level constraint-system prover and verifier.

The port of `binius_tpu/constraint_system/prove.py`. Proving runs these
phases on one device (CUDA unless the caller names another):

  1. setup: observe the constraint-system digest;
  2. commit: pack the committed columns, RS-encode and Merkle-commit them,
     the root to the transcript;
  3. exp: the exponentiation phase, the GKR walk of every exponent's
     circuit (`exp.prove_phase`; nothing for a system with no exponents);
     its layer witnesses and result columns are computed before the
     commit;
  4. zerocheck over all constraint sets: the univariate-skip reduction, or
     the eq-indicator sumcheck when no round is skipped;
  5. evalcheck: reduce the virtual oracles' claims to committed ones;
  6. ring switch: committed small-field claims -> PIOP sumcheck claims;
  7. PIOP: the sumcheck interleaved with FRI, and the query phase.

Channels (flushes, boundaries' balance) and non-zero claims are not
ported: a system that has them raises `NotImplementedError`.
`last_phase_times` holds the last proof's seconds per phase.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..device import resolve
from ..fields import tower
from ..math.arith import CompositionPoly
from ..protocols import evalcheck, piop, ring_switch
from ..protocols import fri as fri_mod
from ..protocols.sumcheck import univariate_zerocheck as uzc
from ..protocols.sumcheck import zerocheck as zc
from ..protocols.sumcheck.common import LEVEL
from ..transcript.transcript import ProverTranscript, VerifierTranscript
from . import exp as exp_mod
from .system import ConstraintSystem

SECURITY_BITS = 100

last_phase_times: dict = {}


class _PhaseTimer:
    """Wall seconds per phase; on a CUDA device each phase ends with a
    synchronize, so a phase's time holds its device work. Each phase is
    also a `torch.profiler.record_function` range, "prove.<phase>", that a
    profiler of the proof sees (`scripts/profile_opening.py --proof`). A
    phase entered twice (exp: its witnesses before the commit, its GKR
    walk after) sums both spans."""

    def __init__(self, device: torch.device):
        self.device = device
        self.times: dict = {}
        self._t0 = time.perf_counter()
        self._cur = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def phase(self, name: str) -> None:
        self._finish()
        rf = torch.profiler.record_function(f"prove.{name}")
        rf.__enter__()
        self._cur = (name, time.perf_counter(), rf)

    def _finish(self) -> None:
        if self._cur is not None:
            self._sync()
            name, t0, rf = self._cur
            rf.__exit__(None, None, None)
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0
            self._cur = None

    def done(self) -> dict:
        self._finish()
        self.times["total"] = time.perf_counter() - self._t0
        last_phase_times.clear()
        last_phase_times.update(self.times)
        return self.times


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


def _refuse_unported(system: ConstraintSystem, boundaries) -> None:
    if system.flushes or system.non_zero_claims or boundaries:
        raise NotImplementedError(
            "channels, boundaries and non-zero claims (the grand-product phase) are not ported")


def _observe_setup(transcript, system: ConstraintSystem) -> None:
    transcript.observe().write_bytes(system.digest())
    transcript.observe()   # the (empty) boundaries: obtaining the writer is observed


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
          log_inv_rate: int = 1, device=None) -> bytes:
    """witness: oracle id -> (level, tensor) for the committed and virtual
    oracles (`m3.builder.witness.WitnessIndex.to_core_witness`). Runs on
    CUDA unless `device` names another; the witness moves there."""
    _refuse_unported(system, boundaries)
    dev = resolve(device)
    timer = _PhaseTimer(dev)
    transcript = ProverTranscript()
    _observe_setup(transcript, system)
    witness = {oid: (lvl, d.to(dev)) for oid, (lvl, d) in witness.items()}

    timer.phase("exp")   # the layer witnesses and result columns, which the commit needs
    exp_witnesses = exp_mod.make_exp_witnesses(system, witness)
    timer.phase("commit")
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
    codeword, tree, _ = piop.commit(fri_params, layout.commit_meta, packed_mles, dev)
    transcript.message().write_bytes(tree.root)

    timer.phase("exp")
    ec_exp = exp_mod.prove_phase(system, witness, exp_witnesses, transcript)

    timer.phase("zerocheck")
    skip = _zerocheck_skip(system)
    if skip > 0:
        sets, claims = _zerocheck_claims(system, ascending=True)
        out = uzc.batch_prove(claims, [[witness[oid] for oid in s.oracle_ids] for s in sets],
                              transcript, skip)
        ec_claims = _skip_evalcheck_claims(sets, out)
    else:
        sets, claims = _zerocheck_claims(system)
        out = zc.batch_prove(claims, [[tower.resolve_p1(*witness[oid]) for oid in s.oracle_ids]
                                      for s in sets], transcript, order_high=False)
        ec_claims = _to_evalcheck_claims(sets, out, False)
    ec_claims += ec_exp

    timer.phase("evalcheck")
    committed_claims = evalcheck.prove(system.oracles, witness, ec_claims, transcript)

    timer.phase("ring_switch")
    rs_claims = _ring_switch_claims(system, layout, committed_claims)
    reduced = ring_switch.prove(rs_claims, [witness[oid] for oid in layout.oracle_ids],
                                transcript, dev)

    timer.phase("piop")
    piop.prove(fri_params, layout.commit_meta, codeword, tree, packed_mles,
               reduced.transparent_mles, reduced.sumcheck_claims, transcript, dev)
    proof = transcript.finalize()
    timer.done()
    return proof


def verify(system: ConstraintSystem, proof: bytes, boundaries: list = (),
           log_inv_rate: int = 1, device=None) -> None:
    """Raises ValueError (or EOFError on a short proof) unless the proof
    verifies. Host code, but for the ring switch's transparents, which
    evaluate batched on `device` (CUDA unless named)."""
    _refuse_unported(system, boundaries)
    transcript = VerifierTranscript(proof)
    _observe_setup(transcript, system)
    layout = CommitLayout.from_system(system)
    fri_params = make_fri_params(layout.commit_meta, log_inv_rate)
    commitment = transcript.message().read_bytes(32)
    ec_exp = exp_mod.verify_phase(system, transcript)

    skip = _zerocheck_skip(system)
    if skip > 0:
        sets, claims = _zerocheck_claims(system, ascending=True)
        ec_claims = _skip_evalcheck_claims(sets, uzc.batch_verify(claims, transcript, skip))
    else:
        sets, claims = _zerocheck_claims(system)
        ec_claims = _to_evalcheck_claims(
            sets, zc.batch_verify(claims, transcript, order_high=False), False)
    ec_claims += ec_exp

    committed_claims = evalcheck.verify(system.oracles, ec_claims, transcript)
    rs_claims = _ring_switch_claims(system, layout, committed_claims)
    reduced = ring_switch.verify(rs_claims, transcript, device)
    piop.verify(fri_params, layout.commit_meta, commitment, reduced.transparent_mles,
                reduced.sumcheck_claims, transcript)
    transcript.finalize()

"""Evalcheck: reduce evaluation claims on virtual oracles to claims on
committed oracles.

The port of `binius_tpu/protocols/evalcheck.py`: claims walk the oracle
DAG; a linear combination sends its inner evaluations, a shifted or packed
oracle spawns a bivariate sumcheck (against its shift indicator or the
tower basis) and a composite one an eq-indicator sumcheck; each wave's
sumchecks are batch-proven (`sumcheck.prove.batch_prove`, folding low to
high), and their reduced claims form the next wave, until only claims on
committed oracles remain. Duplicate (oracle, point) claims are dropped
deterministically on both sides. Per wave, the prover evaluates the
linear combinations' inner columns in one batched evaluation per (level,
n_vars, point) group, each run of composite claims of one expression at
one point (the flush oracles of one size) is one stacked sumcheck prover
(`EqStackedSumcheckProver`), and
both sides take the shift indicators of all the wave's shift claims in
one stacked carry DP.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constraint_system import oracle as om
from ..fields import scalar, tower
from ..math import mle
from ..math.arith import ArithExpr, CompositionPoly, bivariate_product
from . import shift_ind
from .sumcheck import prove as sc_prove
from .sumcheck import verify as sc_verify
from .sumcheck.common import LEVEL, CompositeSumClaim, SumcheckClaim


@dataclasses.dataclass(frozen=True)
class EvalcheckClaim:
    oracle_id: int
    point: tuple  # B128 ints
    eval: int


def _dedup_key(c: EvalcheckClaim):
    return (c.oracle_id, c.point)


@dataclasses.dataclass
class _ShiftEntry:
    claim: EvalcheckClaim
    oracle: om.Oracle
    kind: str = "shift"  # "shift" | "packed"

    @property
    def block_bits(self) -> int:
        return self.oracle.shift_block_bits if self.kind == "shift" else self.oracle.log_degree


@dataclasses.dataclass
class _CompositeEntry:
    claim: EvalcheckClaim
    oracle: om.Oracle


class _Walker:
    """The reduction walk, shared by the prover and the verifier; only the
    transcript IO differs."""

    def __init__(self, oracles: om.OracleSet, transcript, is_prover: bool, witness=None):
        self.oracles = oracles
        self.transcript = transcript
        self.is_prover = is_prover
        self.witness = witness  # prover: oracle id -> (level, tensor)
        self.device = next(iter(witness.values()))[1].device if witness else None
        self.committed: list[EvalcheckClaim] = []
        self.seen: dict = {}
        self._eq_memo: dict = {}
        self._wit_evals: dict = {}  # (oracle id, point) -> evaluation

    def _eq_expansion(self, point: tuple) -> torch.Tensor:
        e = self._eq_memo.get(point)
        if e is None:
            e = mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, list(point), self.device))
            self._eq_memo[point] = e
        return e

    def _prefetch_witness_evals(self, queue) -> None:
        """Evaluate every inner oracle of the queue's linear-combination
        claims, which the prover sends: one batched evaluation per (level,
        n_vars, point) group of multilinears."""
        groups: dict = {}
        for claim in queue:
            o = self.oracles[claim.oracle_id]
            if o.variant != om.LINEAR_COMBINATION or _dedup_key(claim) in self.seen:
                continue
            for iid in o.inner:
                if (iid, claim.point) not in self._wit_evals:
                    key = (self.witness[iid][0], self.oracles[iid].n_vars, claim.point)
                    groups.setdefault(key, {})[iid] = None
        for (level, n, point), iids in groups.items():
            stack = torch.stack([self.witness[i][1] for i in iids])
            _, out = mle.batched_evaluate_partial_high(level, stack, n,
                                                       self._eq_expansion(point), 0)
            for i, v in zip(iids, tower.to_ints(LEVEL, out[:, 0])):
                self._wit_evals[(i, point)] = v

    def _io_scalars(self, values_if_prover):
        if self.is_prover:
            self.transcript.message().write_scalars(LEVEL, values_if_prover)
            return values_if_prover
        return self.transcript.message().read_scalars(LEVEL, values_if_prover)

    def run(self, claims: list[EvalcheckClaim]) -> list[EvalcheckClaim]:
        queue = list(claims)
        while queue:
            if self.is_prover:
                self._prefetch_witness_evals(queue)
            shift_entries: list[_ShiftEntry] = []
            composite_entries: list[_CompositeEntry] = []
            next_queue: list[EvalcheckClaim] = []
            for claim in queue:
                key = _dedup_key(claim)
                if key in self.seen:
                    if self.seen[key] != claim.eval:
                        raise ValueError("conflicting duplicate evaluation claims")
                    continue
                self.seen[key] = claim.eval
                self._process(claim, shift_entries, composite_entries, next_queue)
            if shift_entries or composite_entries:
                next_queue.extend(self._run_sumcheck_batch(shift_entries, composite_entries))
            queue = next_queue
        return self.committed

    def _process(self, claim: EvalcheckClaim, shift_entries, composite_entries,
                 next_queue) -> None:
        o = self.oracles[claim.oracle_id]
        if o.variant == om.COMMITTED:
            self.committed.append(claim)
        elif o.variant == om.TRANSPARENT:
            if not self.is_prover:
                if o.transparent.evaluate_scalar(list(claim.point)) != claim.eval:
                    raise ValueError(f"transparent oracle {o.id} evaluation mismatch")
        elif o.variant == om.REPEATING:
            inner = self.oracles[o.inner[0]]
            next_queue.append(EvalcheckClaim(inner.id, claim.point[:inner.n_vars], claim.eval))
        elif o.variant == om.LINEAR_COMBINATION:
            if self.is_prover:
                evals = [self._wit_evals[(i, claim.point)] for i in o.inner]
                self._io_scalars(evals)
            else:
                evals = self._io_scalars(len(o.inner))
                acc = o.lc_offset
                for e, c in zip(evals, o.lc_coeffs):
                    acc ^= scalar.mul(LEVEL, e, c)
                if acc != claim.eval:
                    raise ValueError(f"linear combination oracle {o.id} mismatch")
            for i, e in zip(o.inner, evals):
                next_queue.append(EvalcheckClaim(i, claim.point, e))
        elif o.variant == om.SHIFTED:
            shift_entries.append(_ShiftEntry(claim, o))
        elif o.variant == om.COMPOSITE:
            composite_entries.append(_CompositeEntry(claim, o))
        else:
            raise NotImplementedError(f"evalcheck for oracle variant {o.variant} is not ported")

    def _shift_pair_stack(self, entries: list[_ShiftEntry], b: int) -> torch.Tensor:
        """(2k, 2^b, 4) B128 stack [proj_0, ind_0, proj_1, ind_1, ...] for k
        shift entries of block bits b: each inner multilinear projected at
        the claim's high coordinates (batched per (level, n_vars, suffix)),
        beside its shift indicator's partial multilinear."""
        k = len(entries)
        groups: dict = {}
        for idx, e in enumerate(entries):
            inner = self.oracles[e.oracle.inner[0]]
            ilevel, _ = self.witness[e.oracle.inner[0]]
            groups.setdefault((ilevel, inner.n_vars, tuple(e.claim.point[b:])), []).append(idx)
        chunks, order = [], []
        for (ilevel, n, z_high), idxs in groups.items():
            stack = torch.stack([self.witness[entries[i].oracle.inner[0]][1] for i in idxs])
            if n == b:
                ilevel, stack = tower.resolve_p1(ilevel, stack)
                proj = tower.embed(ilevel, LEVEL, stack)
            else:
                _, proj = mle.batched_evaluate_partial_high(
                    ilevel, stack, n, self._eq_expansion(z_high), b)
            chunks.append(proj)
            order.extend(idxs)
        inv = [0] * k
        for pos, idx in enumerate(order):
            inv[idx] = pos
        proj_all = torch.cat(chunks)[torch.tensor(inv, dtype=torch.long, device=self.device)]
        ind = shift_ind.partial_mle_batch(
            [e.oracle.shift_variant for e in entries], b,
            [e.oracle.shift_offset for e in entries],
            [list(e.claim.point[:b]) for e in entries], self.device)
        return torch.stack([proj_all, ind], dim=1).reshape(2 * k, 1 << b, 4)

    def _run_sumcheck_batch(self, shift_entries, composite_entries) -> list[EvalcheckClaim]:
        """Batch-prove or verify the sumchecks of a wave's shifted and
        composite oracles; returns the reduced inner-oracle claims."""
        specs = []  # (kind, entry, n_vars)
        for e in sorted(shift_entries, key=lambda e: -e.block_bits):
            specs.append((e.kind, e, e.block_bits))
        for e in composite_entries:
            specs.append(("composite", e, e.oracle.n_vars))
        specs.sort(key=lambda s: -s[2])  # stable: shifts keep their order

        claims, eq_points = [], []
        for kind, e, nv in specs:
            if kind == "shift":
                claims.append(SumcheckClaim(
                    nv, 2, (CompositeSumClaim(bivariate_product(), e.claim.eval),)))
                eq_points.append(None)
            else:
                o = e.oracle
                shifted = o.composite.remap_vars({i: i + 1 for i in range(len(o.inner))})
                comp = CompositionPoly(ArithExpr.var(0) * shifted, len(o.inner) + 1)
                claims.append(SumcheckClaim(
                    nv, len(o.inner) + 1, (CompositeSumClaim(comp, e.claim.eval),)))
                eq_points.append(list(e.claim.point))

        if self.is_prover:
            provers = []
            i = 0
            while i < len(specs):
                kind, e, nv = specs[i]
                if kind == "shift":
                    # a run of shift specs of equal n_vars: one batched prover
                    j = i
                    while j < len(specs) and specs[j][0] == "shift" and specs[j][2] == nv:
                        j += 1
                    provers.append(sc_prove.BatchedBivariateSumcheckProver(
                        claims[i:j], self._shift_pair_stack([s[1] for s in specs[i:j]], nv),
                        order_high=False))
                    i = j
                else:
                    # a run of composites of one expression at one point (the
                    # flush oracles of one size): one stacked prover
                    o = e.oracle
                    key = (nv, e.claim.point, o.composite, len(o.inner))
                    j = i + 1
                    while (j < len(specs) and specs[j][0] == "composite"
                           and (specs[j][2], specs[j][1].claim.point, specs[j][1].oracle.composite,
                                len(specs[j][1].oracle.inner)) == key):
                        j += 1
                    run = [s[1].oracle for s in specs[i:j]]
                    ids = list(dict.fromkeys(ii for r in run for ii in r.inner))
                    pos = {ii: p for p, ii in enumerate(ids)}
                    eq_ml = (LEVEL, self._eq_expansion(tuple(e.claim.point)))
                    provers.append(sc_prove.EqStackedSumcheckProver(
                        claims[i:j], getattr(o.composite, "expr", o.composite),
                        sc_prove._stack([self.witness[ii] for ii in ids] + [eq_ml], nv),
                        [[pos[ii] for ii in r.inner] for r in run], e.claim.point))
                    i = j
            out = sc_prove.batch_prove(provers, self.transcript)
            ml_evals, challenges = out.multilinear_evals, out.challenges
        else:
            ver = sc_verify.batch_verify(claims, self.transcript, order_high=False,
                                         eq_ind_points=eq_points)
            ml_evals, challenges = ver.multilinear_evals, ver.challenges

        n_rounds = claims[0].n_vars if claims else 0
        points = [sc_verify.claim_point(n_rounds, nv, challenges, order_high=False)
                  for _, _, nv in specs]
        if not self.is_prover:
            # the wave's shift-indicator checks, as one stacked carry DP
            shifts = [(i, e.oracle) for i, (kind, e, _) in enumerate(specs) if kind == "shift"]
            wants = dict(zip([i for i, _ in shifts], shift_ind.evaluate_scalar_batch(
                [o.shift_variant for _, o in shifts], [o.shift_block_bits for _, o in shifts],
                [o.shift_offset for _, o in shifts],
                [list(specs[i][1].claim.point[:o.shift_block_bits]) for i, o in shifts],
                [list(points[i]) for i, _ in shifts])))
        new_claims = []
        for i, ((kind, e, nv), evals) in enumerate(zip(specs, ml_evals)):
            o = e.oracle
            pt = points[i]
            if kind == "shift":
                b = o.shift_block_bits
                proj_eval, ind_eval = evals
                if not self.is_prover and ind_eval != wants[i]:
                    raise ValueError("shift indicator evaluation mismatch")
                new_claims.append(EvalcheckClaim(o.inner[0], tuple(pt) + tuple(e.claim.point[b:]),
                                                 proj_eval))
            else:
                for iid, ev in zip(o.inner, evals[1:]):
                    new_claims.append(EvalcheckClaim(iid, tuple(pt), ev))
        return new_claims


def prove(oracles: om.OracleSet, witness: dict, claims: list[EvalcheckClaim],
          transcript) -> list[EvalcheckClaim]:
    """Reduce claims to committed-oracle claims, writing helper data to the
    transcript. `witness` maps oracle id -> (level, tensor) for the
    committed and inner oracles the claims reach."""
    return _Walker(oracles, transcript, True, witness).run(claims)


def verify(oracles: om.OracleSet, claims: list[EvalcheckClaim],
           transcript) -> list[EvalcheckClaim]:
    return _Walker(oracles, transcript, False).run(claims)

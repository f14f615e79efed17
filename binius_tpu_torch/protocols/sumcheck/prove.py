"""Sumcheck provers.

The port of `binius_tpu/protocols/sumcheck/prove.py`: `RegularSumcheckProver`
(any compositions, either folding order, the eq-indicator mode of the
zerocheck and the evalcheck), `BivariateSumcheckProver` (products of two
multilinears: the PIOP and the zerocheck's univariatizing reduction),
`BatchedBivariateSumcheckProver` (k independent product claims as one
stack: the evalcheck's shift claims), `EqStackedSumcheckProver` (k
claims of one composition at one eq-indicator point as one stack: the
grand-product layers and the evalcheck's flush composites) and the
rear-loaded `batch_prove`.

A prover holds its multilinears as one (m, 2^n, 4) B128 stack on its
device. A round takes the two halves of the folding variable as views
(the high half first when `order_high`, else the even and odd rows),
extrapolates them to the domain's other points, lays the points side by
side along the element axis and evaluates each composition once over all
of them. Compositions of one shape (after `compact_compositions`) are one
evaluation over a gather of their members' rows (`evaluate_grouped`:
keccak's 600 chi constraints are two shapes). The XOR-reduced sums are
mixed with the batch's weights on the device, and only the mixed sums
cross to the host, which interpolates one round polynomial per prover
(`compute_mixed_round_poly`; interpolation is linear). A product prover
reorders its rows once, at construction, so that the composition operands
are two contiguous blocks. `GroupedRegularSumcheckProver` proves G claims
of one structure as one (G, m, 2^n, 4) stack: one evaluation pass and one
fold per round for the whole group.

Under a mesh (`mesh=`), a regular or grouped prover holds this rank's
1/N of each multilinear, laid out so that the folding variable's pairs
are on one rank (every N-th row for a fold of the high variable,
`parallel.mesh.to_strided`; a contiguous block for the low one). A
round's sums are this rank's, XOR-reduced over the ranks
(`mesh.xor_all_reduce`), and when log2(N) variables are left the N
remaining rows are gathered and the rest runs on every rank. The JAX
package's power-of-4 shape buckets, streamed chunks and batch gates exist
for XLA's compile cache and program size, and are not carried over.
"""

from __future__ import annotations

import dataclasses

import torch

from ...fields import tower
from ...math import mle
from ...math.univariate import EvaluationDomain
from ...parallel import mesh as mesh_mod
from ...utils import tracing
from . import common, front_loaded
from .common import LEVEL, SumcheckClaim


def _halves(stack: torch.Tensor, n_remaining: int, order_high: bool):
    """(evals at X = 0, evals at X = 1) of the folding variable, as views
    of the stack's first 2^n_remaining rows of each multilinear."""
    n = 1 << n_remaining
    if order_high:
        return stack[:, :n // 2], stack[:, n // 2:n]
    d = stack[:, :n].reshape(stack.shape[0], n // 2, 2, stack.shape[-1])
    return d[:, :, 0], d[:, :, 1]


def _at_points(e0: torch.Tensor, e1: torch.Tensor, points) -> torch.Tensor:
    """The multilinears at every domain point, the points side by side on
    the element axis: (m, n_points * half, 4)."""
    diff = None
    out = []
    for x in points:
        if x == 0:
            out.append(e0)
        elif x == 1:
            out.append(e1)
        else:
            if diff is None:
                diff = e0 ^ e1
            out.append(e0 ^ tower.mul(LEVEL, diff, tower.full(LEVEL, (), x, e0.device)))
    return torch.cat(out, dim=1)


def _fold(stack: torch.Tensor, n_remaining: int, order_high: bool, challenge: int) -> torch.Tensor:
    e0, e1 = _halves(stack, n_remaining, order_high)
    r = tower.full(LEVEL, (), challenge, stack.device)
    return e0 ^ tower.mul(LEVEL, e0 ^ e1, r)


def _point_sums(vals: torch.Tensor, n_points: int) -> torch.Tensor:
    """(k, n_points * half, 4) composite values -> (k, n_points, 4) sums."""
    return tower.xor_reduce(vals.reshape(vals.shape[0], n_points, -1, 4), 2)


def _interpolate_mixed(domain: EvaluationDomain, sums: torch.Tensor,
                       weights: list[int]) -> list[int]:
    """sum_j weights[j] * (round polynomial j): the point sums are mixed on
    the device before the one interpolation (which is linear)."""
    w = tower.from_ints(LEVEL, weights, sums.device)
    mixed = tower.xor_reduce(tower.mul(LEVEL, sums, w[:, None, :]), 0)
    return domain.interpolate(LEVEL, tower.to_ints(LEVEL, mixed))


def _group_comp_specs(comp_specs) -> list:
    """Partition compact compositions [(expr over its own used variables,
    used multilinear indices)] by identical structure: [(expr, used rows
    per member, original indices)]. A claim of one table partition holds
    many copies of a few expressions over different columns (keccak: 600
    compositions of two shapes); each shape evaluates once over a stack
    of its members' inputs."""
    order: dict = {}
    for ci, (cexpr, used) in enumerate(comp_specs):
        order.setdefault((cexpr, len(used)), []).append((tuple(used), ci))
    return [(cexpr, tuple(u for u, _ in entries), tuple(ci for _, ci in entries))
            for (cexpr, _k), entries in order.items()]


def compact_compositions(exprs) -> list:
    """[(expr remapped onto the variables it uses, those variables)], the
    variables numbered in the order they first appear in the expression,
    so that expressions of one shape over differently ordered columns
    compact to the same expression."""
    out = []
    for e in exprs:
        used: dict = {}
        stack = [e]
        while stack:
            node = stack.pop()
            if node.op == "var":
                used.setdefault(node.value, len(used))
            else:
                stack.extend(reversed(node.args))
        out.append((e.remap_vars(used), tuple(used)))
    return out


def evaluate_grouped(level: int, groups: list, rows: torch.Tensor) -> torch.Tensor:
    """Every composition of `groups` (`_group_comp_specs`) over the stack
    `rows` (m, ...) at `level`: (n_comps, ...), in the original order. A
    shape of G members is one evaluation over a (G, k, ...) gather of
    their k inputs each."""
    parts, order = [], []
    for cexpr, used_rows, origs in groups:
        if len(origs) == 1:
            vals = cexpr.evaluate(level, [rows[u] for u in used_rows[0]])[None]
        else:
            idx = torch.tensor(used_rows, dtype=torch.long, device=rows.device)
            sub = rows[idx]                                   # (G, k, ...)
            vals = cexpr.evaluate(level, [sub[:, i] for i in range(idx.shape[1])])
        parts.append(vals.expand(len(origs), *rows.shape[1:]))
        order.extend(origs)
    return in_order(parts, order)


def group_by_level(mls: list) -> dict:
    """{level: indices of the multilinears [(level, data)] at it}."""
    groups: dict = {}
    for i, (lvl, _) in enumerate(mls):
        groups.setdefault(lvl, []).append(i)
    return groups


def in_order(parts: list, order: list) -> torch.Tensor:
    """Concatenated groups of rows back in their original order: `order`
    lists the original index of each concatenated row."""
    full = torch.cat(parts) if len(parts) > 1 else parts[0]
    if order != list(range(len(order))):
        inv = [0] * len(order)
        for pos, i in enumerate(order):
            inv[i] = pos
        full = full[torch.tensor(inv, dtype=torch.long, device=full.device)]
    return full


def _stack(multilinears, n_vars: int) -> torch.Tensor:
    """[(level, data)] of 2^n_vars elements (bit-packed B1 allowed) -> one
    (m, 2^n_vars, 4) B128 stack, built per level in a few batched ops."""
    parts, order = [], []
    for lvl, idxs in group_by_level(multilinears).items():
        lvl, d = tower.resolve_p1(lvl, torch.stack([multilinears[i][1] for i in idxs]))
        d = d.reshape(tower.elem_shape(lvl, (len(idxs), 1 << n_vars)))
        parts.append(tower.embed(lvl, LEVEL, d) if lvl < LEVEL else d)
        order.extend(idxs)
    return in_order(parts, order)


class _MeshRows:
    """A prover's rows on a mesh: `self.stack` (rows, 2^(n_remaining -
    log2 N), 4) is this rank's part, laid out so that the folding pairs are
    local (see the module's docstring); `self.mesh` is None once the rows
    are whole."""

    def _init_mesh(self, mesh) -> None:
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._shift = self.mesh.log_size if self.mesh is not None else 0
        self._gather_if_done()

    @property
    def _local_vars(self) -> int:
        return self.n_remaining - self._shift

    def _reduce(self, sums: torch.Tensor) -> torch.Tensor:
        return sums if self.mesh is None else mesh_mod.xor_all_reduce(self.mesh, sums)

    def _gather_if_done(self) -> None:
        """At log2 N variables left each rank holds one row per multilinear,
        the one whose index is its rank: gather them, in rank order."""
        if self.mesh is not None and self.n_remaining <= self._shift:
            g = mesh_mod.all_gather(self.mesh, self.stack[:, :1])    # (N, rows, 1, 4)
            self.stack = g[:, :, 0].transpose(0, 1).contiguous()
            self.mesh, self._shift = None, 0

    def fold(self, challenge: int) -> None:
        self.stack = _fold(self.stack, self._local_vars, self.order_high, challenge)
        self.n_remaining -= 1
        self._gather_if_done()


class RegularSumcheckProver(_MeshRows):
    """Proves a `SumcheckClaim` over its multilinears [(level, tensor)].

    `eq_ind_challenges`: multilinear 0 is the eq-indicator expansion of
    that point; its final evaluation is recomputed by the verifier instead
    of being sent (the zerocheck and evalcheck convention). `mesh`: the
    multilinears are this rank's parts (see the module's docstring)."""

    def __init__(self, claim: SumcheckClaim, multilinears, order_high: bool,
                 eq_ind_challenges: tuple | None = None, mesh=None):
        assert len(multilinears) == claim.n_multilinears
        self.claim = claim
        self.order_high = order_high
        self.eq_ind_challenges = eq_ind_challenges
        self.n_remaining = claim.n_vars
        shift = mesh.log_size if mesh is not None else 0
        self.stack = _stack(multilinears, claim.n_vars - shift)
        self._init_mesh(mesh)
        self.domain = EvaluationDomain.from_subspace(3, claim.max_individual_degree() + 1)
        self._groups = _group_comp_specs(compact_compositions(
            cs.composition.expr for cs in claim.composite_sums))

    @property
    def n_vars(self) -> int:
        return self.claim.n_vars

    def _round_sums(self) -> torch.Tensor:
        """(n_comps, n_points, 4): each composite's sums at the domain's
        points, on the device."""
        pts = self.domain.points
        ev = _at_points(*_halves(self.stack, self._local_vars, self.order_high), pts)
        return self._reduce(_point_sums(evaluate_grouped(LEVEL, self._groups, ev), len(pts)))

    def compute_mixed_round_poly(self, weights: list[int]) -> list[int]:
        """sum_j weights[j] * (round polynomial of composite j)."""
        if not self.claim.composite_sums:
            return []
        return _interpolate_mixed(self.domain, self._round_sums(), weights)

    def finish(self) -> list[int]:
        """Multilinear evaluations at the bound point."""
        assert self.n_remaining == 0
        return tower.to_ints(LEVEL, self.stack[:, 0])


class BivariateSumcheckProver:
    """Prover for a claim whose composites are all products of two of its
    multilinears. `prestacked`: an (m, 2^n_vars, 4) B128 stack built by the
    caller, in place of `multilinears`.

    The rows are reordered once, at construction, into [first operands of
    every composite, second operands, multilinears in no composite], a
    multilinear repeated where several composites read it, so that a
    round's products are one product of two contiguous blocks."""

    eq_ind_challenges = None

    def __init__(self, claim: SumcheckClaim, multilinears=None, order_high: bool = True,
                 prestacked=None):
        self.claim = claim
        self.order_high = order_high
        self.n_remaining = claim.n_vars
        if prestacked is not None:
            assert prestacked.shape[0] == claim.n_multilinears
            stack = prestacked
        else:
            assert len(multilinears) == claim.n_multilinears
            stack = _stack(multilinears, claim.n_vars)
        idx_a, idx_b = [], []
        for cs in claim.composite_sums:
            expr = cs.composition.expr
            assert expr.op == "mul" and expr.args[0].op == "var" and expr.args[1].op == "var", \
                "BivariateSumcheckProver requires pure product compositions"
            idx_a.append(expr.args[0].value)
            idx_b.append(expr.args[1].value)
        self._init_rows(stack, idx_a, idx_b)

    def _init_rows(self, stack: torch.Tensor, idx_a: list, idx_b: list) -> None:
        m = stack.shape[0]
        order = idx_a + idx_b
        in_comp = set(order)
        order += [i for i in range(m) if i not in in_comp]
        if order != list(range(m)):
            stack = stack[torch.tensor(order, dtype=torch.long, device=stack.device)]
        self.stack = stack
        self.n_comps = len(idx_a)
        first = {}
        for pos, i in enumerate(order):
            first.setdefault(i, pos)
        self._row_of = [first[i] for i in range(m)]
        self.domain = EvaluationDomain.from_subspace(3, 3)

    @property
    def n_vars(self) -> int:
        return self.claim.n_vars

    def _round_sums(self) -> torch.Tensor:
        """(n_comps, 3, 4): each composite's sums at X = 0, 1, 2."""
        k = self.n_comps
        e0, e1 = _halves(self.stack, self.n_remaining, self.order_high)
        ev = _at_points(e0[:2 * k], e1[:2 * k], self.domain.points)
        return _point_sums(tower.mul(LEVEL, ev[:k], ev[k:]), 3)

    def compute_mixed_round_poly(self, weights: list[int]) -> list[int]:
        if not self.n_comps:
            return []
        return _interpolate_mixed(self.domain, self._round_sums(), weights)

    def fold(self, challenge: int) -> None:
        self.stack = _fold(self.stack, self.n_remaining, self.order_high, challenge)
        self.n_remaining -= 1

    def finish(self) -> list[int]:
        assert self.n_remaining == 0
        vals = tower.to_ints(LEVEL, self.stack[:, 0])
        return [vals[r] for r in self._row_of]


class BatchedBivariateSumcheckProver(BivariateSumcheckProver):
    """k independent bivariate-product claims of equal n_vars as one stack:
    `pair_stack` (2k, 2^n_vars, 4) B128, rows [ml0 of claim 0, ml1 of claim
    0, ml0 of claim 1, ...]. `batch_prove` samples one batching coefficient
    per claim; round polynomials and final evaluations come per claim, so
    the transcript equals that of k separate provers."""

    multi_claim = True

    def __init__(self, claims: list, pair_stack, order_high: bool = False):
        assert claims and pair_stack.shape[0] == 2 * len(claims)
        nv = claims[0].n_vars
        assert all(c.n_vars == nv for c in claims)
        self.claims = claims
        self.claim = claims[0]
        self.n_claims = len(claims)
        self.order_high = order_high
        self.n_remaining = nv
        k = self.n_claims
        self._init_rows(pair_stack, list(range(0, 2 * k, 2)), list(range(1, 2 * k, 2)))

    def finish(self) -> list[list[int]]:
        """Per claim, [ml0 eval, ml1 eval]."""
        vals = super().finish()
        return [vals[2 * i:2 * i + 2] for i in range(self.n_claims)]


class GroupedRegularSumcheckProver(_MeshRows):
    """G claims of one structure (n_vars, multilinear count and order,
    compositions) as one stack: `gstack` (G, m, 2^n_vars, 4) B128, claim
    major (with `eq_ind_challenges`, row 0 of every claim is the shared eq
    expansion). A round is one evaluation pass over the whole group: the
    claims' halves at the domain's points, each composition shape evaluated
    once over every claim's rows (`evaluate_grouped`), the sums mixed on
    the device and read by the host once; a fold is one fold of the whole
    stack.

    The multi-claim interface of `EqStackedSumcheckProver`: one batching
    coefficient per claim, claim g's composite j weighted by its
    coefficient to the power j + 1 (as the front-loaded batch weighs one
    claim's composites; the same as `batch_prove`'s weight for claims of
    one composite), and `finish` one list of evaluations per claim, so the
    transcript is that of G `RegularSumcheckProver`s. `mesh`: `gstack` is
    this rank's part of the element axis (see the module's docstring)."""

    multi_claim = True

    def __init__(self, claims: list, gstack: torch.Tensor, order_high: bool,
                 eq_ind_challenges: tuple | None = None, mesh=None):
        assert claims
        nv = claims[0].n_vars
        exprs = [cs.composition.expr for cs in claims[0].composite_sums]
        assert all(c.n_vars == nv and c.n_multilinears == claims[0].n_multilinears
                   and [cs.composition.expr for cs in c.composite_sums] == exprs
                   for c in claims)
        G, m = gstack.shape[0], gstack.shape[1]
        assert G == len(claims) and m == claims[0].n_multilinears
        self.claims = claims
        self.claim = claims[0]
        self.n_claims = G
        self.order_high = order_high
        self.eq_ind_challenges = eq_ind_challenges
        self.n_remaining = nv
        self.stack = gstack.reshape(G * m, gstack.shape[2], 4)
        self._init_mesh(mesh)
        self.domain = EvaluationDomain.from_subspace(3, self.claim.max_individual_degree() + 1)
        self._groups = _group_comp_specs(compact_compositions(exprs))
        self._n_comps = len(exprs)

    @property
    def n_vars(self) -> int:
        return self.claim.n_vars

    def _round_sums(self) -> torch.Tensor:
        """(n_comps * G, n_points, 4), composite major: each claim's
        composite sums at the domain's points."""
        G, pts = self.n_claims, self.domain.points
        e0, e1 = _halves(self.stack, self._local_vars, self.order_high)
        m, half = e0.shape[0] // G, e0.shape[1]
        per = max(1, STACKED_CHUNK_ELEMS // max(1, (m + self._n_comps) * len(pts) * half))
        out = []
        for g0 in range(0, G, per):
            rows = slice(g0 * m, min(G, g0 + per) * m)
            ev = _at_points(e0[rows], e1[rows], pts)              # (gc m, P half, 4)
            ev = ev.reshape(-1, m, *ev.shape[1:]).transpose(0, 1)  # (m, gc, P half, 4)
            vals = evaluate_grouped(LEVEL, self._groups, ev)       # (n_comps, gc, P half, 4)
            out.append(tower.xor_reduce(
                vals.reshape(*vals.shape[:2], len(pts), half, 4), 3))
        sums = torch.cat(out, dim=1) if len(out) > 1 else out[0]   # (n_comps, G, P, 4)
        return self._reduce(sums.reshape(-1, len(pts), 4))

    def compute_mixed_round_poly(self, weights: list[int]) -> list[int]:
        """weights: one batching coefficient per claim."""
        if not self._n_comps:
            return []
        pw = [front_loaded.powers(c, self._n_comps) for c in weights]
        return _interpolate_mixed(self.domain, self._round_sums(),
                                  [pw[g][j] for j in range(self._n_comps)
                                   for g in range(self.n_claims)])

    def finish(self) -> list[list[int]]:
        """Per claim, its multilinears' evaluations (eq's included)."""
        assert self.n_remaining == 0
        vals = tower.to_ints(LEVEL, self.stack[:, 0])
        m = len(vals) // self.n_claims
        return [vals[g * m:(g + 1) * m] for g in range(self.n_claims)]


# Elements of one gathered operand of `EqStackedSumcheckProver`'s round (2^26
# B128 elements: 1 GiB); a batch of more claims runs its round in chunks of
# claims.
STACKED_CHUNK_ELEMS = 1 << 26


class EqStackedSumcheckProver:
    """Claims of one composition C over one eq-indicator point, as one
    stack: claim j proves sum_y eq(z, y) * C(its r multilinears at y) = s_j.

    `stack` (U + 1, 2^n, 4) B128 holds the distinct multilinears of the
    batch once, then the eq expansion of `eq_point` as its last row;
    `rows` (one tuple of r stack rows per claim) picks each claim's, and
    `expr` is C over var(i) = the claim's i-th multilinear. A
    round gathers the claims' rows (in chunks of claims within
    `STACKED_CHUNK_ELEMS`), evaluates C at the domain's points over all of
    them at once, weights each point's values by eq and XOR-reduces:
    (claims, points) sums on the device, which `batch_prove` mixes with
    the claims' coefficients into one round polynomial (one host read per
    round, however many claims). `batch_prove` samples one coefficient per
    claim and writes each claim's evaluations without the eq one, so the
    transcript is that of one `RegularSumcheckProver` per claim over
    [eq, its multilinears]; the eq multilinear is folded once for all."""

    multi_claim = True
    order_high = False

    def __init__(self, claims: list, expr, stack: torch.Tensor, rows, eq_point):
        nv = claims[0].n_vars
        assert all(c.n_vars == nv for c in claims) and len(rows) == len(claims)
        assert stack.shape[1] == 1 << nv
        self.claims = claims
        self.claim = claims[0]
        self.n_claims = len(claims)
        self.expr = expr
        self.eq_ind_challenges = tuple(eq_point)
        self.n_remaining = nv
        self.stack = stack
        self.rows = torch.tensor(rows, dtype=torch.long, device=stack.device).reshape(
            len(rows), -1)
        self.domain = EvaluationDomain.from_subspace(3, claims[0].max_individual_degree() + 1)

    @property
    def n_vars(self) -> int:
        return self.claim.n_vars

    def _round_sums(self) -> torch.Tensor:
        """(claims, points, 4): each claim's sums at the domain's points."""
        e0, e1 = _halves(self.stack, self.n_remaining, False)
        q0, q1 = e0[-1], e1[-1]
        qd = q0 ^ q1
        n_in = self.rows.shape[1]
        per = max(1, STACKED_CHUNK_ELEMS // (n_in * q0.shape[0]))
        out = []
        for g0 in range(0, self.n_claims, per):
            idx = self.rows[g0:g0 + per]
            s0, s1 = e0[idx], e1[idx]                      # (c, r, half, 4)
            sd = s0 ^ s1
            sums = []
            for x in self.domain.points:
                if x in (0, 1):
                    v, q = (s0, q0) if x == 0 else (s1, q1)
                else:
                    xs = tower.full(LEVEL, (), x, s0.device)
                    v = s0 ^ tower.mul(LEVEL, sd, xs)
                    q = q0 ^ tower.mul(LEVEL, qd, xs)
                c = self.expr.evaluate(LEVEL, [v[:, i] for i in range(n_in)])
                sums.append(tower.xor_reduce(tower.mul(LEVEL, c, q), 1))
            out.append(torch.stack(sums, dim=1))
        return torch.cat(out) if len(out) > 1 else out[0]

    def compute_mixed_round_poly(self, weights: list[int]) -> list[int]:
        return _interpolate_mixed(self.domain, self._round_sums(), weights)

    def fold(self, challenge: int) -> None:
        self.stack = _fold(self.stack, self.n_remaining, False, challenge)
        self.n_remaining -= 1

    def finish(self) -> list[list[int]]:
        """Per claim, [eq evaluation, its multilinears' evaluations]."""
        assert self.n_remaining == 0
        vals = tower.to_ints(LEVEL, self.stack[:, 0])
        tracing.count("readbacks")
        return [[vals[-1], *(vals[r] for r in row)] for row in self.rows.tolist()]


@dataclasses.dataclass
class BatchSumcheckOutput:
    challenges: list         # sampled challenges, in round order
    multilinear_evals: list  # per claim: its evals (eq-indicator eval included)


def batch_prove(provers: list, transcript) -> BatchSumcheckOutput:
    """Rear-loaded batched sumcheck; provers sorted descending by n_vars,
    one folding order. A prover of several claims (`multi_claim`) takes one
    batching coefficient per claim. Spans of `utils.tracing`, as the
    front-loaded prover's: "sumcheck.round", "sumcheck.fold",
    "sumcheck.finish"."""
    assert all(provers[i].n_vars >= provers[i + 1].n_vars for i in range(len(provers) - 1))
    n_rounds = provers[0].n_vars if provers else 0
    batch_coeffs: list[int] = []
    coeff_start: list[int] = []
    challenges: list[int] = []
    next_idx = 0

    def activate(idx: int) -> None:
        coeff_start.append(len(batch_coeffs))
        for _ in range(getattr(provers[idx], "n_claims", 1)):
            batch_coeffs.append(transcript.sample_scalar(LEVEL))

    for rnd in range(n_rounds):
        while next_idx < len(provers) and provers[next_idx].n_vars == n_rounds - rnd:
            activate(next_idx)
            next_idx += 1
        with tracing.span("sumcheck.round"):
            combined: list[int] = []
            for pi, p in enumerate(provers[:next_idx]):
                if getattr(p, "multi_claim", False):
                    # one product composite per claim, each its own coefficient
                    phis = batch_coeffs[coeff_start[pi]:coeff_start[pi] + p.n_claims]
                else:
                    phis = [batch_coeffs[coeff_start[pi]]] * len(p.claim.composite_sums)
                combined = common.add_coeffs(combined, p.compute_mixed_round_poly(phis))
            transcript.message().write_scalars(LEVEL, common.truncate(combined))
        challenge = transcript.sample_scalar(LEVEL)
        challenges.append(challenge)
        with tracing.span("sumcheck.fold"):
            for p in provers[:next_idx]:
                p.fold(challenge)
    while next_idx < len(provers) and provers[next_idx].n_vars == 0:
        activate(next_idx)
        next_idx += 1
    all_evals = []
    with tracing.span("sumcheck.finish"):
        for p in provers:
            if getattr(p, "multi_claim", False):
                for evals in p.finish():
                    send = evals[1:] if p.eq_ind_challenges is not None else evals
                    transcript.message().write_scalars(LEVEL, send)
                    all_evals.append(evals)
            else:
                evals = p.finish()
                send = evals[1:] if p.eq_ind_challenges is not None else evals
                transcript.message().write_scalars(LEVEL, send)
                all_evals.append(evals)
    return BatchSumcheckOutput(challenges, all_evals)


def eq_ind_expansion_multilinear(point: list[int], device=None):
    """(level, data) of the eq-indicator expansion of `point` (variable 0 =
    point[0]) on `device`."""
    return LEVEL, mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, point, device))

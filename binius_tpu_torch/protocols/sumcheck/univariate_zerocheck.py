"""Univariate-skip batched zerocheck.

The port of `binius_tpu/protocols/sumcheck/univariate_zerocheck.py`, a
three-stage reduction:

  1. **Univariate round**: the first `skip_rounds` (low) variables of every
     claim are univariatized over a binary-subspace NTT domain at B8. The
     honest round polynomial vanishes on the first 2^skip domain points,
     so only its values on the extension cosets are sent. Each
     multilinear is extended to those cosets by a small-field additive NTT
     (inverse, then forward on each coset), the compositions are evaluated
     in the small field (those of one shape as one stacked expression),
     weighted by the eq indicator over the unskipped variables and
     XOR-reduced over the suffixes.
  2. **Eq-indicator sumchecks** over the remaining variables, high to low,
     front-loaded with the univariate round's batching coefficients.
  3. **Univariatizing reduction**: one `skip_rounds`-variable sumcheck of
     products (each multilinear projected at the stage-2 point, times the
     Lagrange coefficients' multilinear) that turns the univariatized
     evaluations back into multilinear evaluation claims.

The transcript order is the JAX package's: the stage-2 eq challenges are
sampled before the batching coefficients, and the univariate round's
message is always obtained, even when it is empty, before `u_challenge`.
Claims of a lower degree compute their round on their own smaller domain
and are extended to the batch's with `OddInterpolate`. The suffixes are
chunked only to bound the memory of one chunk (`_CHUNK_ELEMS`). Stage 1's
NTT takes the route the JAX package's `_uni_chunk_jit` takes: a chunk
whose data is at B32 or above (a claim over B32 multilinears, or one with
a B64 or B128 multilinear or constant, where the data is B128) and whose
rows, padded with zero rows to a power of two m_pad, make a flat batch of
m_pad * chunk * 2^k >= 2^15 elements is transformed as that one batch, shape
(0, k, log2(m_pad * chunk)), by the bitsliced path (`bitsliced_ntt`: K2, K3
and K4 where a plan has cross runs, on the card; B8 twiddles); every other
chunk (B8 or B16 data, smaller batches) keeps the packed stage loop on its
(m, chunk * 2^k) rows. The rest of the device work is plain PyTorch but
K1's products. Each stage of the prover is a
`torch.profiler.record_function` range, "zerocheck.stage<i>"; each ends
with values read back to the host, and `last_stage_times` holds the last
proof's wall seconds per stage.

Stage 2 proves a run of adjacent claims of one structure
(`_structure_key`) as one `GroupedRegularSumcheckProver` when grouping is
on (`group_claims`; by default on CUDA, off on the CPU, the JAX package's
split between its accelerator and the CPU); the bytes are those of one
prover per claim.

Under a mesh (multilinears given as `parallel.mesh.RowShard` blocks), a
claim of n variables runs sharded when n - skip >= log2(ranks) and each
rank's block holds whole words: stage 1 on this rank's suffixes with its
eq rows and one XOR all-reduce of the round's values; the skipped fold
rank-local, then one all-to-all to the strided layout of the high-first
stage 2 (where the folded block is too small for it, an all-gather);
stage 3's projection on this rank's suffixes and one all-reduce. Smaller
claims are gathered and proven whole on every rank.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ...fields import scalar, tower
from ...math import mle
from ...math.arith import ArithExpr, CompositionPoly
from ...math.univariate import lagrange_evals_device, lagrange_evals_np
from ...ntt import bitsliced_ntt
from ...ntt.additive_ntt import AdditiveNTT, NTTDomain
from ...parallel import mesh as mesh_mod
from . import prove as sc_prove
from .common import LEVEL, CompositeSumClaim, SumcheckClaim
from .front_loaded import FrontLoadedBatchProver, FrontLoadedBatchVerifier, powers
from .zerocheck import ZerocheckClaim, to_sumcheck_claim

DOMAIN_LEVEL = 3  # B8 NTT twiddles

last_stage_times: dict = {}

# words held by one stage-1 chunk per stack row: the m multilinears'
# extensions and the compositions' weighted values (4 words each) over
# chunk suffixes x the P coset points
_CHUNK_ELEMS = 1 << 26


def _max_degree(zc: ZerocheckClaim) -> int:
    return max((c.degree() for c in zc.compositions), default=0)


def compute_skip_rounds(zc_claims: list[ZerocheckClaim]) -> int:
    """min_i(domain_bits - log2_ceil(max_deg_i)), capped at the largest
    claim's n_vars; claims with fewer variables are high-padded."""
    if not zc_claims:
        return 0
    domain_bits = 1 << DOMAIN_LEVEL
    max_skip = min(domain_bits - max(0, (_max_degree(c) - 1).bit_length())
                   for c in zc_claims)
    return max(0, min(max_skip, max(c.n_vars for c in zc_claims)))


def _high_pad(zc_claims: list[ZerocheckClaim], mls_per_claim: list, k: int):
    """Claims with n_vars < k repeat their evaluations 2^(k - n_vars) times
    on the high variables; the reduced claim for such a claim restricts to
    its first n_vars skipped challenges."""
    out_c, out_m = [], []
    for zc, mls in zip(zc_claims, mls_per_claim):
        if zc.n_vars >= k:
            out_c.append(zc)
            out_m.append(mls)
            continue
        rep = 1 << (k - zc.n_vars)
        padded = []
        for lvl, d in mls:
            lvl, d = tower.resolve_p1(lvl, d)
            padded.append((lvl, d.repeat(rep, *[1] * (d.ndim - 1))))
        out_c.append(dataclasses.replace(zc, n_vars=k))
        out_m.append(padded)
    return out_c, out_m


@dataclasses.dataclass
class BatchZerocheckOutput:
    skipped_challenges: list      # skip_rounds challenges (variable order, low)
    unskipped_challenges: list    # stage-2 challenges (round order, high to low)
    multilinear_evals: list       # per claim: evals of its multilinears
    eval_points: list             # per claim: full eval point (variable order)


def _domain_points(max_domain_size: int) -> tuple:
    dom_log = max(1, (max_domain_size - 1).bit_length())
    dom = NTTDomain.create(DOMAIN_LEVEL, dom_log)
    return tuple(dom.subspace.get(i) for i in range(max_domain_size))


def _compact_compositions(zc: ZerocheckClaim) -> list:
    """[(expr over the variables it uses, those variables)] per composition."""
    return sc_prove.compact_compositions(c.expr for c in zc.compositions)


def _group_claims(override: bool | None, device: torch.device) -> bool:
    """The grouping gate: `override` where given, else on for CUDA and off
    for the CPU."""
    return override if override is not None else device.type == "cuda"


def _structure_key(zc: ZerocheckClaim):
    """Claims of equal keys share their structure exactly and prove as one
    `GroupedRegularSumcheckProver` (the tables of one gadget: merkle_tree's
    nodes tables)."""
    return (zc.n_vars, zc.n_multilinears, tuple(c.expr for c in zc.compositions))


def _sharded(n: int, k: int, mesh) -> bool:
    """A claim of n variables runs on this rank's blocks: every rank holds
    whole suffixes (n - k >= log2 N) and whole words of bit-packed columns."""
    return mesh is not None and n - k >= mesh.log_size and n - mesh.log_size >= 5


def _eq_rows(point: list[int], device, mesh=None, strided: bool = False) -> torch.Tensor:
    """The eq expansion of `point`, or this rank's rows of it: its
    contiguous block (the high log2 N variables fixed to the rank's bits)
    or, `strided`, every N-th row from its rank (the low ones fixed):
    a scalar times the expansion of the other variables."""
    if mesh is None:
        return mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, point, device))
    b = mesh.log_size
    fixed, rest = (point[:b], point[b:]) if strided else (point[len(point) - b:],
                                                          point[:len(point) - b])
    c = 1
    for i, p in enumerate(fixed):
        c = scalar.mul(LEVEL, c, p if (mesh.rank >> i) & 1 else p ^ 1)
    e = mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, rest, device))
    return tower.mul(LEVEL, e, tower.full(LEVEL, (), c, device))


def _claim_round_evals(zc: ZerocheckClaim, mls: list, eq_pt: list[int], k: int,
                       n_cosets: int, dom_log: int, mesh=None) -> torch.Tensor:
    """(n_comps, P, 4) B128 univariate round evaluations on cosets
    1..n_cosets-1 of the skip subspace, P = (n_cosets - 1) << k. `mesh`:
    `mls` are this rank's blocks; its suffixes are weighted by its eq rows
    and the values summed over the ranks."""
    device = mls[0][1].device
    n = zc.n_vars - (mesh.log_size if mesh is not None else 0)
    eq = _eq_rows(eq_pt, device, mesh)
    const_level = max((c.expr.binary_tower_level() for c in zc.compositions), default=0)
    levels = [lvl for lvl, _ in mls]
    if any(lvl > 5 for lvl in levels) or const_level > 5:
        data_level = LEVEL
    else:
        data_level = max([DOMAIN_LEVEL, const_level, *[max(lvl, 0) for lvl in levels]])
    m = len(mls)
    suffix = 1 << (n - k)
    width = (m + 4 * len(zc.compositions)) * max(1, n_cosets - 1) << k
    chunk = 1 << min(n - k, max(0, (_CHUNK_ELEMS // width).bit_length() - 1))
    if (chunk << k) % 32:
        mls = [tower.resolve_p1(lvl, d) for lvl, d in mls]
    # the NTT's operand: one flat batch of m_pad rows (zero rows after the
    # m multilinears) where the bitsliced transform takes it, else the m rows
    m_pad = 1 << (m - 1).bit_length()
    flat = bitsliced_ntt.supported(DOMAIN_LEVEL, data_level, (m_pad * chunk) << k)
    n_rows = m_pad if flat else m
    shape = (0, k, (m_pad * chunk).bit_length() - 1 if flat else 0)
    # the multilinears stacked once per level (bit-packed B1 ones as words)
    by_level = sc_prove.group_by_level(mls)
    stacks = [(lvl, torch.stack([mls[i][1] for i in idxs])) for lvl, idxs in by_level.items()]
    order = [i for idxs in by_level.values() for i in idxs] + list(range(m, n_rows))

    def rows(s0: int) -> torch.Tensor:
        """The chunk's slice of every multilinear at data_level, and the
        zero rows: (n_rows, chunk << k[, limbs])."""
        out = []
        for lvl, st in stacks:
            if lvl == tower.P1:
                sl = tower.unpack_b1(st[:, (s0 << k) // 32:((s0 + chunk) << k) // 32])
                lvl = 0
            else:
                sl = st[:, s0 << k:(s0 + chunk) << k]
            out.append(tower.embed(lvl, data_level, sl))
        if n_rows > m:
            out.append(tower.zeros(data_level, (n_rows - m, chunk << k), device))
        return sc_prove.in_order(out, order)

    groups = sc_prove._group_comp_specs(_compact_compositions(zc))
    ntt = AdditiveNTT(NTTDomain.create(DOMAIN_LEVEL, dom_log))
    coset_bits = dom_log - k
    acc = None
    for s0 in range(0, suffix, chunk):
        sub = rows(s0)
        if flat:
            sub = sub.reshape(tower.elem_shape(data_level, ((n_rows * chunk) << k,)))
        coeffs = ntt.inverse(sub, data_level, shape, 0, coset_bits, device=device)
        cosets = [ntt.forward(coeffs, data_level, shape, c, coset_bits, device=device)
                  .reshape(tower.elem_shape(data_level, (n_rows, chunk, 1 << k)))[:m]
                  for c in range(1, n_cosets)]
        ext = torch.cat(cosets, dim=2)                     # (m, chunk, P[, limbs])
        vals = sc_prove.evaluate_grouped(data_level, groups, ext)   # (n_comps, chunk, P[, limbs])
        part = tower.xor_reduce(tower.scale_subfield(
            data_level, LEVEL, vals, eq[None, s0:s0 + chunk, None, :]), 1)
        acc = part if acc is None else acc ^ part
    return acc if mesh is None else mesh_mod.xor_all_reduce(mesh, acc)


def _run_front_loaded_prove(provers, transcript, coeffs=None):
    fl = FrontLoadedBatchProver(provers, transcript, coeffs=coeffs)
    n_rounds = max((p.n_vars for p in provers), default=0)
    challenges = []
    for _ in range(n_rounds):
        fl.send_round_proof(transcript)
        ch = transcript.sample_scalar(LEVEL)
        challenges.append(ch)
        fl.receive_challenge(ch)
    fl.finish(transcript)
    return fl, challenges


def _run_front_loaded_verify(claims, transcript, coeffs=None, presummed=None,
                             eq_ind_points=None):
    fl = FrontLoadedBatchVerifier(claims, transcript, coeffs=coeffs,
                                  presummed=presummed, eq_ind_points=eq_ind_points)
    n_rounds = max((c.n_vars for c in claims), default=0)
    for _ in range(n_rounds):
        fl.try_finish_claims(transcript)
        fl.receive_round_proof(transcript)
        ch = transcript.sample_scalar(LEVEL)
        fl.challenges.append(ch)
        fl.finish_round(ch)
    fl.try_finish_claims(transcript)
    fl.finish()
    return fl


def _reduction_composites(n_total: int, sums: list[int]):
    return tuple(
        CompositeSumClaim(
            CompositionPoly(ArithExpr.var(i) * ArithExpr.var(n_total), n_total + 1), s)
        for i, s in enumerate(sums))


def _fold_skipped(mls: list, n: int, k: int, lagr_cube: torch.Tensor) -> torch.Tensor:
    """Bind the low k variables of each multilinear with the Lagrange
    coefficients: (len(mls), 2^(n-k), 4) B128, in the multilinears' order.
    The multilinears of a whole group of claims fold in one pass per
    level (`_fold_skipped_group`)."""
    parts, order = [], []
    for lvl, idxs in sc_prove.group_by_level(mls).items():
        stack = torch.stack([mls[i][1] for i in idxs])
        parts.append(mle.batched_evaluate_partial_low(lvl, stack, n, lagr_cube, k)[1])
        order.extend(idxs)
    return sc_prove.in_order(parts, order)


def _fold_skipped_group(mls_per_claim: list, n: int, k: int,
                        lagr_cube: torch.Tensor) -> torch.Tensor:
    """`_fold_skipped` over every claim of a group in one pass per level:
    (G, m, 2^(n-k), 4), claim major."""
    flat = [ml for mls in mls_per_claim for ml in mls]
    body = _fold_skipped(flat, n, k, lagr_cube)
    return body.reshape(len(mls_per_claim), -1, *body.shape[1:])


def _project_skipped_stacked(mls: list, n: int, k: int, point: list[int],
                             mesh=None) -> torch.Tensor:
    """Bind the high n - k variables of each multilinear at `point`: one
    (len(mls), 2^k, 4) B128 stack in the multilinears' order. `mesh`: the
    multilinears are this rank's blocks (n their variables less log2 N),
    projected with its eq rows and summed over the ranks."""
    device = mls[0][1].device
    parts, order = [], []
    whole = n == k and mesh is None         # nothing to bind
    eq = None if whole else _eq_rows(point, device, mesh)
    for lvl, idxs in sc_prove.group_by_level(mls).items():
        stack = torch.stack([mls[i][1] for i in idxs])
        if whole:
            lvl, stack = tower.resolve_p1(lvl, stack)
            parts.append(tower.embed(lvl, LEVEL, stack) if lvl < LEVEL else stack)
        else:
            parts.append(mle.batched_evaluate_partial_high(lvl, stack, n, eq, k, mesh)[1])
        order.extend(idxs)
    return sc_prove.in_order(parts, order)


def _extrapolate_round_evals(ev: torch.Tensor, d_i: int, max_d: int, k: int,
                             dom_log: int) -> torch.Tensor:
    """Round evaluations on a claim's own domain (d_i * 2^k points, the zero
    prefix re-added) interpolated into the novel basis with
    `OddInterpolate` over the B128 domain, zero-extended, transformed to
    the whole domain and trimmed to the batch's domain without its zero
    prefix (host scalars: fewer than 2^8 values per composition)."""
    from ...ntt.odd_interpolate import OddInterpolate

    n_rows, per_in = ev.shape[0], ev.shape[1]
    flat = tower.to_ints(LEVEL, ev)
    rows = [flat[i * per_in:(i + 1) * per_in] for i in range(n_rows)]
    n = d_i << k
    ell = (n & -n).bit_length() - 1
    dom = NTTDomain.create(LEVEL, dom_log)
    oi = OddInterpolate.create(dom, n >> ell, ell, dom_log - ell)
    ntt = AdditiveNTT(dom)
    out: list[int] = []
    for row in rows:
        vals = [0] * (1 << k) + row
        coeffs = oi.inverse_transform(vals) + [0] * ((1 << dom_log) - n)
        evals = ntt.forward_scalar(coeffs, LEVEL, dom_log)
        out.extend(evals[1 << k:max_d << k])
    per = (max_d - 1) << k
    return tower.from_ints(LEVEL, out, ev.device).reshape(n_rows, per, 4)


def batch_prove(zc_claims: list[ZerocheckClaim], mls_per_claim: list, transcript,
                skip_rounds: int, group_claims: bool | None = None) -> BatchZerocheckOutput:
    """Claims sorted ASCENDING by n_vars, skip_rounds <= the largest n_vars
    (smaller claims high-pad). Writes the three stages to `transcript`.
    `group_claims`: prove runs of same-structure claims as one grouped
    prover in stage 2 (None: on CUDA, off on the CPU)."""
    assert zc_claims
    assert all(zc_claims[i].n_vars <= zc_claims[i + 1].n_vars
               for i in range(len(zc_claims) - 1))
    k = skip_rounds
    assert 0 < k <= zc_claims[-1].n_vars
    mesh = next((mesh_mod.mesh_of(d) for mls in mls_per_claim for _, d in mls
                 if mesh_mod.is_mesh_sharded(d)), None)
    sharded = [_sharded(zc.n_vars, k, mesh) for zc in zc_claims]
    # this rank's blocks of a sharded claim, the whole multilinears of the rest
    mls_per_claim = [[(lvl, mesh_mod.block_of(mesh, d) if sh else mesh_mod.pull_local(d))
                      for lvl, d in mls] for mls, sh in zip(mls_per_claim, sharded)]
    shift = [mesh.log_size if sh else 0 for sh in sharded]
    device = mls_per_claim[0][0][1].device
    orig_nvars = [zc.n_vars for zc in zc_claims]
    zc_claims, mls_per_claim = _high_pad(zc_claims, mls_per_claim, k)
    max_n = zc_claims[-1].n_vars
    r = transcript.sample_scalars(LEVEL, max_n - k)  # unskipped eq challenges
    eq_pts = [r[len(r) - (zc.n_vars - k):] if zc.n_vars > k else [] for zc in zc_claims]

    max_d = max(_max_degree(zc) for zc in zc_claims)
    max_domain_size = max(max_d, 1) << k
    points = _domain_points(max_domain_size)
    dom_log = max(1, (max_domain_size - 1).bit_length())

    # --- stage 1: the univariate round, each claim on its own domain ---
    last_stage_times.clear()
    t0 = time.perf_counter()
    with torch.profiler.record_function("zerocheck.stage1"):
        batch_coeffs = [transcript.sample_scalar(LEVEL) for _ in zc_claims]
        r_claims = []
        for i, (zc, mls) in enumerate(zip(zc_claims, mls_per_claim)):
            d_i = _max_degree(zc)
            if d_i < 2:
                # degree < 2^k with 2^k roots: the round polynomial is zero
                r_claims.append(tower.zeros(
                    LEVEL, (len(zc.compositions), max(max_d - 1, 0) << k), device))
                continue
            ev = _claim_round_evals(zc, mls, eq_pts[i], k, d_i, dom_log,
                                    mesh if sharded[i] else None)
            if d_i < max_d:
                ev = _extrapolate_round_evals(ev, d_i, max_d, k, dom_log)
            r_claims.append(ev)
        r_all = torch.cat(r_claims)                                # (total_comps, P, 4)
        # composition j of claim i weighs phi_i^(j+1)
        weights = [w for phi, zc in zip(batch_coeffs, zc_claims)
                   for w in powers(phi, len(zc.compositions))]
        msg = transcript.message()   # always obtained, even when nothing is written
        if max_d >= 2:
            w_dev = tower.from_ints(LEVEL, weights, device)
            mixed = tower.xor_reduce(tower.mul(LEVEL, r_all, w_dev[:, None, :]), 0)
            msg.write_scalars(LEVEL, tower.to_ints(LEVEL, mixed))
        u_challenge = transcript.sample_scalar(LEVEL)

        if max_d >= 2:
            tail = lagrange_evals_device(points, u_challenge, device)[1 << k:]
            claimed_sums = tower.to_ints(LEVEL, tower.inner_product(LEVEL, r_all, tail[None], 1))
        else:
            claimed_sums = [0] * sum(len(zc.compositions) for zc in zc_claims)

    # --- stage 2: eq-indicator sumchecks over the unskipped variables ---
    t0 = _stage_done("stage1", t0)
    with torch.profiler.record_function("zerocheck.stage2"):
        lagr_cube = lagrange_evals_device(points[:1 << k], u_challenge, device)   # (2^k, 4)
        comp_starts = [0]
        for zc in zc_claims:
            comp_starts.append(comp_starts[-1] + len(zc.compositions))

        def s2_claim(g: int) -> SumcheckClaim:
            zc = zc_claims[g]
            sums = claimed_sums[comp_starts[g]:comp_starts[g + 1]]
            return SumcheckClaim(zc.n_vars - k, zc.n_multilinears + 1, tuple(
                CompositeSumClaim(cs.composition, s)
                for cs, s in zip(to_sumcheck_claim(zc).composite_sums, sums)))

        group_ok = _group_claims(group_claims, device)
        s2_provers = []
        i = 0
        while i < len(zc_claims):
            zc, eq_pt = zc_claims[i], eq_pts[i]
            j = i + 1
            if group_ok and zc.n_vars - k >= 1:
                key = _structure_key(zc)
                while j < len(zc_claims) and _structure_key(zc_claims[j]) == key:
                    j += 1
            nf = zc.n_vars - k - shift[i]            # variables of the folded block
            body = _fold_skipped_group(mls_per_claim[i:j], nf + k, k, lagr_cube)
            m2 = None
            if sharded[i]:
                # the high-first rounds pair rows 2^(nf + log N - 1) apart:
                # lay the blocks out strided (or gather them when too small)
                if nf >= mesh.log_size:
                    m2 = mesh
                    body = mesh_mod.to_strided(mesh, body, 2).local
                else:
                    body = mesh_mod.pull_local(mesh_mod.RowShard(body, mesh, 2))
            eq = _eq_rows(list(eq_pt), device, m2, strided=True)
            if j - i >= 2:
                gstack = torch.cat([eq.expand(j - i, 1, *eq.shape), body], dim=1)
                s2_provers.append(sc_prove.GroupedRegularSumcheckProver(
                    [s2_claim(g) for g in range(i, j)], gstack, order_high=True,
                    eq_ind_challenges=tuple(eq_pt), mesh=m2))
            else:
                s2_provers.append(sc_prove.RegularSumcheckProver(
                    s2_claim(i), [(LEVEL, eq)] + [(LEVEL, b) for b in body[0]],
                    order_high=True, eq_ind_challenges=tuple(eq_pt), mesh=m2))
            del body
            i = j
        fl2, s2_challenges = _run_front_loaded_prove(s2_provers, transcript, coeffs=batch_coeffs)
        del s2_provers

    # --- stage 3: the univariatizing reduction over the skipped variables ---
    t0 = _stage_done("stage2", t0)
    with torch.profiler.record_function("zerocheck.stage3"):
        red_sums = []
        for i in range(len(zc_claims)):
            red_sums.extend(fl2.multilinear_evals[i][1:])   # without the eq eval
        proj_parts = []
        i = 0
        while i < len(zc_claims):   # claims of equal n_vars project together
            nv = zc_claims[i].n_vars
            j = i + 1
            while j < len(zc_claims) and zc_claims[j].n_vars == nv:
                j += 1
            flat_mls = [ml for g in range(i, j) for ml in mls_per_claim[g]]
            proj_parts.append(_project_skipped_stacked(
                flat_mls, nv - shift[i], k, list(reversed(s2_challenges[:nv - k])),
                mesh if sharded[i] else None))
            i = j
        proj_stack = torch.cat([*proj_parts, lagr_cube[None]])
        n_total = proj_stack.shape[0] - 1
        red_claim = SumcheckClaim(k, n_total + 1, _reduction_composites(n_total, red_sums))
        red_prover = sc_prove.BivariateSumcheckProver(red_claim, prestacked=proj_stack,
                                                      order_high=True)
        fl3, s3_challenges = _run_front_loaded_prove([red_prover], transcript)
    _stage_done("stage3", t0)
    skipped = list(reversed(s3_challenges))
    concat_evals = fl3.multilinear_evals[0]
    assert len(concat_evals) == n_total + 1
    return _regroup(zc_claims, orig_nvars, concat_evals, skipped, s2_challenges)


def _stage_done(name: str, t0: float) -> float:
    t = time.perf_counter()
    last_stage_times[name] = t - t0
    return t


def _regroup(zc_claims, orig_nvars, concat_evals, skipped, s2_challenges):
    """Per claim, its evaluations and point (skipped ++ its unskipped); a
    high-padded claim's point is its first n_vars skipped challenges."""
    out_evals, out_points = [], []
    pos = 0
    for zc, n0 in zip(zc_claims, orig_nvars):
        out_evals.append(concat_evals[pos:pos + zc.n_multilinears])
        pos += zc.n_multilinears
        pt = skipped + list(reversed(s2_challenges[:zc.n_vars - len(skipped)]))
        out_points.append(pt[:n0] if n0 < len(skipped) else pt)
    return BatchZerocheckOutput(skipped, s2_challenges, out_evals, out_points)


def batch_verify(zc_claims: list[ZerocheckClaim], transcript,
                 skip_rounds: int) -> BatchZerocheckOutput:
    assert zc_claims
    assert all(zc_claims[i].n_vars <= zc_claims[i + 1].n_vars
               for i in range(len(zc_claims) - 1))
    k = skip_rounds
    orig_nvars = [zc.n_vars for zc in zc_claims]
    zc_claims = [dataclasses.replace(zc, n_vars=k) if zc.n_vars < k else zc
                 for zc in zc_claims]
    max_n = zc_claims[-1].n_vars
    r = transcript.sample_scalars(LEVEL, max_n - k)
    eq_pts = [r[len(r) - (zc.n_vars - k):] if zc.n_vars > k else [] for zc in zc_claims]

    max_d = max(_max_degree(zc) for zc in zc_claims)
    max_domain_size = max(max_d, 1) << k
    points = _domain_points(max_domain_size)

    batch_coeffs = [transcript.sample_scalar(LEVEL) for _ in zc_claims]
    n_evals = max(max_domain_size - (1 << k), 0)
    round_evals = transcript.message().read_scalars(LEVEL, n_evals)
    u_challenge = transcript.sample_scalar(LEVEL)

    presummed = 0
    if n_evals:
        for ev, lg in zip(round_evals, lagrange_evals_np(points, u_challenge)[1 << k:]):
            presummed ^= scalar.mul(LEVEL, ev, lg)

    # --- stage 2 ---
    s2_claims = [SumcheckClaim(zc.n_vars - k, zc.n_multilinears + 1,
                               to_sumcheck_claim(zc).composite_sums) for zc in zc_claims]
    fl2 = _run_front_loaded_verify(s2_claims, transcript, coeffs=batch_coeffs,
                                   presummed=presummed,
                                   eq_ind_points=[list(p) for p in eq_pts])
    s2_challenges = fl2.challenges

    # --- stage 3 ---
    red_sums = []
    for evals in fl2.multilinear_evals:
        red_sums.extend(evals[1:])
    n_total = len(red_sums)
    red_claim = SumcheckClaim(k, n_total + 1, _reduction_composites(n_total, red_sums))
    fl3 = _run_front_loaded_verify([red_claim], transcript)
    skipped = list(reversed(fl3.challenges))
    concat_evals = list(fl3.multilinear_evals[0])

    # the Lagrange coefficients' multilinear (the last one) at the point
    cube = lagrange_evals_np(points[:1 << k], u_challenge)
    eq = [1]
    for r_pt in skipped:
        eq = ([scalar.mul(LEVEL, c, r_pt ^ 1) for c in eq]
              + [scalar.mul(LEVEL, c, r_pt) for c in eq])
    expected = 0
    for c, e in zip(cube, eq):
        expected ^= scalar.mul(LEVEL, c, e)
    if concat_evals[-1] != expected:
        raise ValueError("univariate skip: Lagrange MLE evaluation mismatch")
    return _regroup(zc_claims, orig_nvars, concat_evals[:-1], skipped, s2_challenges)

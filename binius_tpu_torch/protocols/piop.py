"""FRI-Binius PIOP: batch-commit multilinears, then prove sumcheck claims
about them interleaved with FRI.

Counterpart of `binius_tpu/protocols/piop.py`:

  * `CommitMeta` (multilinears grouped by packed n_vars), `pack_multilinear`,
    `merge_multilins` (pieces most-vars-first, each bit-reversed,
    zero-padded to 2^total_vars), `make_commit_params` and `commit`;
  * `prove` / `verify`: the front-loaded bivariate sumcheck interleaved with
    FRI folding, sharing challenges; the verifier glues the committed evals
    through `evaluate_piecewise_multilinear` against the final FRI value
    (`piop/verify.rs:290-363`).

The sumcheck folds high-to-low: FRI's LSB-pair fold acts on bit-reversed
blocks, which binds each piece's highest variable first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from ..fields import scalar, tower
from ..math.arith import ArithExpr, CompositionPoly
from ..utils import tracing
from . import fri as fri_mod
from .sumcheck import front_loaded
from .sumcheck.common import LEVEL, CompositeSumClaim, SumcheckClaim
from .sumcheck.prove import BivariateSumcheckProver


@dataclasses.dataclass(frozen=True)
class CommitMeta:
    """n_multilins_by_vars[k] = number of committed (packed) multilinears
    with k variables."""

    n_multilins_by_vars: tuple

    @property
    def total_multilins(self) -> int:
        return sum(self.n_multilins_by_vars)

    @property
    def total_elems(self) -> int:
        return sum(c << k for k, c in enumerate(self.n_multilins_by_vars))

    @property
    def total_vars(self) -> int:
        return max((self.total_elems - 1).bit_length(), 0)

    @property
    def max_n_vars(self) -> int:
        return len(self.n_multilins_by_vars) - 1


@dataclasses.dataclass(frozen=True)
class PIOPSumcheckClaim:
    n_vars: int       # packed multilinear vars
    committed: int    # global index of the committed multilinear (ascending order)
    transparent: int  # global index of the transparent multilinear
    sum: int


def pack_multilinear(level: int, data: torch.Tensor, n_vars: int):
    """Small-field multilinear -> packed B128 multilinear; each B128 element
    packs 2^(7-level) consecutive coefficients. Returns (packed, packed_n_vars).

    `level` may be `tower.P1`: bit-packed B1 words are already the B128 limb
    layout, so packing is a view (the prover's commit at
    `constraint_system/prove.py:305-308`)."""
    if level == tower.P1:
        return data.reshape(-1, tower.n_limbs(7)), n_vars - 7
    log_deg = 7 - level
    if n_vars < log_deg:
        # fewer coefficients than one packed element: repeat to fill
        data = torch.cat([data] * (1 << (log_deg - n_vars)), dim=0)
    coeffs = data.reshape(tower.elem_shape(level, (-1, 1 << log_deg)))
    return tower.join_from_subfield(7, level, coeffs), max(n_vars - log_deg, 0)


def _bit_reverse_perm(n_vars: int) -> np.ndarray:
    idx = np.arange(1 << n_vars, dtype=np.int64)
    out = np.zeros_like(idx)
    for b in range(n_vars):
        out |= ((idx >> b) & 1) << (n_vars - 1 - b)
    return out


_DEV_PERMS: dict = {}


def _bit_reverse_perm_on(n_vars: int, device) -> torch.Tensor:
    key = (n_vars, str(device))
    if key not in _DEV_PERMS:
        _DEV_PERMS[key] = torch.from_numpy(_bit_reverse_perm(n_vars)).to(device)
    return _DEV_PERMS[key]


def merge_multilins(pieces: list, total_vars: int) -> torch.Tensor:
    """pieces: [(data, n_vars)] B128 tensors on one device, ascending by
    n_vars -> the merged message (2^total_vars, 4)."""
    device = pieces[0][0].device
    chunks = [data[_bit_reverse_perm_on(n_vars, device)] for data, n_vars in reversed(pieces)]
    pad = (1 << total_vars) - sum(1 << n for _, n in pieces)
    if pad:
        chunks.append(tower.zeros(7, (pad,), device=device))
    return torch.cat(chunks, dim=0)


def make_commit_params(commit_meta: CommitMeta, security_bits: int,
                       log_inv_rate: int) -> fri_mod.FRIParams:
    """FRI params with estimated optimal arity (`piop/verify.rs:137-160`)."""
    log_len = commit_meta.total_vars + log_inv_rate
    arity = fri_mod.estimate_optimal_arity(log_len, 32, 16)
    return fri_mod.FRIParams.choose_with_constant_fold_arity(
        commit_meta.total_vars, security_bits, log_inv_rate, arity)


def commit(fri_params: fri_mod.FRIParams, commit_meta: CommitMeta, packed_mles: list,
           device=None, mesh=None):
    """packed_mles: [(data, n_vars)] ascending by n_vars. Runs on CUDA unless
    `device` names another (`mesh`: on the mesh's device, each rank encoding
    and hashing its block of the codeword, `fri.fri_commit`). Returns
    (codeword, tree, message)."""
    dev = mesh.device if mesh is not None else resolve(device)
    message = merge_multilins([(d.to(dev), n) for d, n in packed_mles], commit_meta.total_vars)
    cw, tree = fri_mod.fri_commit(fri_params, message, dev, mesh)
    return cw, tree, message


def _claim_groups(commit_meta: CommitMeta, transparent_n_vars: list[int],
                  claims: list[PIOPSumcheckClaim]):
    """Claims grouped by n_vars -> (n_vars, committed range, transparent
    range, composite list), as `make_sumcheck_claim_descs`."""
    max_v = commit_meta.max_n_vars
    committed_ranges = []
    off = 0
    for k in range(max_v + 1):
        c = commit_meta.n_multilins_by_vars[k]
        committed_ranges.append((off, off + c))
        off += c
    transparent_ranges = [[0, 0] for _ in range(max_v + 1)]
    cur = 0
    for i, tv in enumerate(transparent_n_vars):
        assert tv >= cur, "transparents must be sorted ascending"
        if tv > cur:
            cur = tv
            transparent_ranges[cur][0] = i
            transparent_ranges[cur][1] = i
        transparent_ranges[cur][1] = i + 1
    descs = []
    for k in range(max_v + 1):
        c0, c1 = committed_ranges[k]
        t0, t1 = transparent_ranges[k]
        comps = []
        for cl in claims:
            if cl.n_vars == k:
                assert c0 <= cl.committed < c1 and t0 <= cl.transparent < t1
                expr = (ArithExpr.var(cl.committed - c0)
                        * ArithExpr.var((c1 - c0) + cl.transparent - t0))
                comps.append(CompositeSumClaim(CompositionPoly(expr, (c1 - c0) + (t1 - t0)),
                                               cl.sum))
        descs.append((k, (c0, c1), (t0, t1), comps))
    return descs


def prove_rounds(fri_params: fri_mod.FRIParams, commit_meta: CommitMeta, codeword: torch.Tensor,
                 tree, packed_mles: list, transparent_mles: list,
                 claims: list[PIOPSumcheckClaim], transcript, device=None) -> fri_mod.FRIFolder:
    """The interleaved rounds of `prove`: each round's sumcheck message, its
    challenge, the FRI fold (a span "fri.fold") and, at arity boundaries,
    the new oracle's root.
    Returns the folder, whose `finish_proof` writes the query phase."""
    dev = resolve(device)
    codeword = codeword.to(dev)
    descs = _claim_groups(commit_meta, [n for _, n in transparent_mles], claims)
    provers = []
    for k, (c0, c1), (t0, t1), comps in descs:
        if c1 == c0:
            continue
        mls = ([(7, torch.as_tensor(packed_mles[i][0]).to(dev)) for i in range(c0, c1)]
               + [(7, torch.as_tensor(transparent_mles[i][0]).to(dev)) for i in range(t0, t1)])
        provers.append(BivariateSumcheckProver(SumcheckClaim(k, len(mls), tuple(comps)), mls))
    batch = front_loaded.FrontLoadedBatchProver(provers, transcript)
    folder = fri_mod.FRIFolder(fri_params, codeword, tree)
    for _ in range(commit_meta.total_vars):
        batch.send_round_proof(transcript)
        challenge = transcript.sample_scalar(LEVEL)
        batch.receive_challenge(challenge)
        with tracing.span("fri.fold"):
            root = folder.execute_fold_round(challenge)
        if root is not None:
            transcript.message().write_bytes(root)
    batch.finish(transcript)
    return folder


def prove(fri_params: fri_mod.FRIParams, commit_meta: CommitMeta, codeword: torch.Tensor,
          tree, packed_mles: list, transparent_mles: list, claims: list[PIOPSumcheckClaim],
          transcript, device=None) -> None:
    """packed_mles / transparent_mles: [(data, n_vars)] ascending by n_vars.
    Runs on CUDA unless `device` names another; the codeword and tree come
    from `commit` on the same device. Two spans of `utils.tracing`: "rounds"
    (the sumcheck interleaved with the FRI folds) and "queries" (the query
    phase and its Merkle openings)."""
    with tracing.span("rounds"):
        folder = prove_rounds(fri_params, commit_meta, codeword, tree, packed_mles,
                              transparent_mles, claims, transcript, device)
    with tracing.span("queries"):
        folder.finish_proof(transcript)


@dataclasses.dataclass
class PIOPVerifyOutput:
    challenges: list
    committed_evals: list    # flat, ascending committed order
    multilinear_evals: list  # per claim group


def verify(fri_params: fri_mod.FRIParams, commit_meta: CommitMeta, commitment: bytes,
           transparents: list, claims: list[PIOPSumcheckClaim], transcript) -> PIOPVerifyOutput:
    """transparents: [(n_vars, eval_fn(point: list[int]) -> int)] ascending
    by n_vars."""
    descs = _claim_groups(commit_meta, [n for n, _ in transparents], claims)
    sc_claims, kept = [], []
    for k, (c0, c1), (t0, t1), comps in descs:
        if c1 == c0:
            continue
        sc_claims.append(SumcheckClaim(k, (c1 - c0) + (t1 - t0), tuple(comps)))
        kept.append((k, (c0, c1), (t0, t1)))
    batch = front_loaded.FrontLoadedBatchVerifier(sc_claims, transcript)
    n_rounds = commit_meta.total_vars
    commit_rounds = {sum(fri_params.fold_arities[:i + 1])
                     for i in range(len(fri_params.fold_arities))}
    challenges, round_commitments = [], []
    for r in range(n_rounds):
        batch.try_finish_claims(transcript)
        batch.receive_round_proof(transcript)
        ch = transcript.sample_scalar(LEVEL)
        challenges.append(ch)
        batch.finish_round(ch)
        if r + 1 in commit_rounds:
            round_commitments.append(transcript.message().read_bytes(32))
    batch.try_finish_claims(transcript)
    batch.finish()
    fri_final = fri_mod.FRIVerifier(fri_params, commitment, round_commitments,
                                    challenges).verify(transcript)

    # the transparents' evaluations, and the committed evals
    challenges_rev = list(reversed(challenges))
    committed_evals = []
    for (k, (c0, c1), (t0, t1)), evals in zip(kept, batch.multilinear_evals):
        committed_evals.extend(evals[:c1 - c0])
        for i, claimed in enumerate(evals[c1 - c0:]):
            n_vars_t, eval_fn = transparents[t0 + i]
            assert n_vars_t == k
            if eval_fn(challenges_rev[len(challenges) - k:]) != claimed:
                raise ValueError(f"transparent {t0 + i} evaluation mismatch")

    # the final FRI value against the piecewise multilinear of the evals
    n_pieces = [commit_meta.n_multilins_by_vars[k] if k < len(commit_meta.n_multilins_by_vars)
                else 0 for k in range(n_rounds + 1)]
    glued = evaluate_piecewise_multilinear(challenges, n_pieces, list(reversed(committed_evals)))
    if glued != fri_final:
        raise ValueError("final FRI value does not match sumcheck evaluations")
    return PIOPVerifyOutput(challenges, committed_evals, batch.multilinear_evals)


def evaluate_piecewise_multilinear(point: list[int], n_pieces_by_vars: list[int],
                                   piece_evals: list[int]) -> int:
    """Host port of `crates/math/src/piecewise_multilinear.rs:46-101`."""
    assert sum(c << k for k, c in enumerate(n_pieces_by_vars)) <= 1 << len(point)
    assert len(piece_evals) == sum(n_pieces_by_vars)
    piece_evals = list(piece_evals)
    index = len(piece_evals)
    n_to_fold = 0
    for i, r in enumerate(point):
        n_to_fold += n_pieces_by_vars[i] if i < len(n_pieces_by_vars) else 0
        seg_start = index - n_to_fold
        seg = piece_evals[seg_start:index]
        folded = []
        for j in range(0, len(seg), 2):
            a = seg[j]
            b = seg[j + 1] if j + 1 < len(seg) else 0
            folded.append(a ^ scalar.mul(LEVEL, a ^ b, r))
        piece_evals[seg_start:seg_start + len(folded)] = folded
        n_folded_out = n_to_fold // 2
        index -= n_folded_out
        n_to_fold -= n_folded_out
    return piece_evals[0]

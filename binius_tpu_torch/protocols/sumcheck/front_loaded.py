"""Front-loaded batched sumcheck (shared *early* challenges).

The port's copy of `binius_tpu/protocols/sumcheck/front_loaded.py`: claims
sorted ascending by n_vars all start at round 0; a claim with k variables
finishes after round k, at which point its multilinear evaluations enter
the transcript and its batched composite evaluation is subtracted from the
running sum. One batching coefficient per claim; composite claims inside a
claim are mixed by powers of it (`batch_weighted_value`). A round-by-round
interface lets the PIOP interleave it with FRI folding. The univariate-skip
zerocheck reuses its own batching coefficients (`coeffs=`, with the
verifier's `presummed=` sum), and an eq-indicator claim's first evaluation
is recomputed by the verifier instead of being sent.
"""

from __future__ import annotations

from ...fields import scalar
from . import common
from .common import LEVEL
from .verify import _eq_scalar


def batch_weighted_value(coeff: int, values: list[int]) -> int:
    """coeff * (v_0 + coeff*v_1 + coeff^2*v_2 + ...) — weight j+1 per value."""
    acc = 0
    for v in reversed(values):
        acc = scalar.mul(LEVEL, acc, coeff) ^ v
    return scalar.mul(LEVEL, coeff, acc)


def powers(c: int, n: int) -> list[int]:
    """[c, c^2, ..., c^n]: the weights of a claim's n composites."""
    out = [c]
    for _ in range(n - 1):
        out.append(scalar.mul(LEVEL, out[-1], c))
    return out[:n]


class FrontLoadedBatchProver:
    """Provers must be sorted ascending by n_vars, order_high folding.

    `coeffs`: pass pre-sampled batching coefficients (the univariate-skip
    zerocheck reuses its univariate-round coefficients,
    `front_loaded.rs` `BatchProver::new_prebatched`); None samples fresh ones.
    Provers with `eq_ind_challenges` set skip their position-0 (eq indicator)
    eval in the transcript — the verifier reconstructs it.

    A prover may carry several claims (`multi_claim = True`), each of one
    composite: it consumes one batching coefficient per claim, its
    `finish` returns one entry per claim, and the transcript stays
    byte-identical to separate per-claim provers. Each round mixes a
    prover's composites with their weights on the device
    (`compute_mixed_round_poly`) before one interpolation.
    """

    def __init__(self, provers: list, transcript, coeffs: list | None = None):
        assert all(provers[i].n_vars <= provers[i + 1].n_vars for i in range(len(provers) - 1))
        self.provers = list(provers)   # queue front = fewest vars
        n_claims = sum(getattr(p, "n_claims", 1) for p in provers)
        if coeffs is None:
            coeffs = transcript.sample_scalars(LEVEL, n_claims)
        assert len(coeffs) == n_claims
        # per-prover claim-coefficient lists, claim order
        self.coeffs: list[list] = []
        pos = 0
        for p in provers:
            n = getattr(p, "n_claims", 1)
            self.coeffs.append(list(coeffs[pos:pos + n]))
            pos += n
        # per prover, the weights of its composites: one coefficient per
        # claim of a multi-claim prover, else the powers of its coefficient
        self.weights: list = [list(cs) if getattr(p, "multi_claim", False)
                              else powers(cs[0], len(p.claim.composite_sums))
                              for p, cs in zip(provers, self.coeffs)]
        self.round = 0
        self.multilinear_evals: list = []  # claim-order final evals (incl. eq)
        self.finish_rounds: list = []      # round at which each claim finished

    def _finish_ready(self, writer) -> None:
        while self.provers and self.provers[0].n_vars == self.round:
            p = self.provers.pop(0)
            self.coeffs.pop(0)
            self.weights.pop(0)
            finished = p.finish()
            per_claim = finished if getattr(p, "multi_claim", False) else [finished]
            for evals in per_claim:
                send = evals[1:] if getattr(p, "eq_ind_challenges", None) is not None else evals
                writer.write_scalars(LEVEL, send)
                self.multilinear_evals.append(evals)
                self.finish_rounds.append(self.round)

    def send_round_proof(self, transcript) -> None:
        w = transcript.message()
        self._finish_ready(w)
        combined: list[int] = []
        for p, weights in zip(self.provers, self.weights):
            combined = common.add_coeffs(combined, p.compute_mixed_round_poly(weights))
        deg = max((max(cs.composition.degree() for cs in p.claim.composite_sums)
                   if p.claim.composite_sums else 0 for p in self.provers), default=0)
        combined = combined + [0] * (deg + 1 - len(combined))
        w.write_scalars(LEVEL, common.truncate(combined))

    def receive_challenge(self, challenge: int) -> None:
        for p in self.provers:
            p.fold(challenge)
        self.round += 1

    def finish(self, transcript) -> None:
        w = transcript.message()
        self._finish_ready(w)
        assert not self.provers, "all claims must finish by the final round"


class FrontLoadedBatchVerifier:
    """Round-by-round verifier; claims ascending by n_vars.

    `coeffs`/`presummed`: prebatched mode — coefficients and the initial
    batched sum come from an outer reduction (univariate-skip zerocheck).
    `eq_ind_points[i]`: claim i's position-0 multilinear is the eq indicator
    of that point; its eval is reconstructed from the challenges instead of
    being read from the transcript.
    """

    def __init__(self, claims: list, transcript, coeffs: list | None = None,
                 presummed: int | None = None, eq_ind_points: list | None = None):
        assert all(claims[i].n_vars <= claims[i + 1].n_vars for i in range(len(claims) - 1))
        self.claims = list(claims)
        if coeffs is None:
            coeffs = transcript.sample_scalars(LEVEL, len(claims))
        assert len(coeffs) == len(claims)
        self.coeffs = list(coeffs)
        if presummed is None:
            s = 0
            for claim, c in zip(self.claims, self.coeffs):
                s ^= batch_weighted_value(c, [cs.sum for cs in claim.composite_sums])
            presummed = s
        self.sum = presummed
        self.eq_ind_points = list(eq_ind_points) if eq_ind_points is not None \
            else [None] * len(claims)
        assert len(self.eq_ind_points) == len(claims)
        self.round = 0
        self.challenges: list = []
        self.multilinear_evals: list = []
        self.finish_rounds: list = []
        self._reader = None

    def _round_reader(self, transcript):
        """EXACTLY one message reader per round (+ one post-loop), created
        unconditionally: obtaining a reader transitions the challenger even
        when nothing is read. The prover's `send_round_proof`/`finish`
        writers mirror this."""
        if self._reader is None:
            self._reader = transcript.message()
        return self._reader

    def try_finish_claims(self, transcript) -> None:
        reader = self._round_reader(transcript)
        while self.claims and self.claims[0].n_vars == self.round:
            claim = self.claims.pop(0)
            coeff = self.coeffs.pop(0)
            eq_pt = self.eq_ind_points.pop(0)
            n_read = claim.n_multilinears - (1 if eq_pt is not None else 0)
            evals = reader.read_scalars(LEVEL, n_read)
            if eq_pt is not None:
                # high-to-low folding: var j of the claim was bound at round
                # (n_vars - 1 - j), i.e. the point is the reversed challenge
                # prefix of length n_vars
                pt = list(reversed(self.challenges[:claim.n_vars]))
                evals = [_eq_scalar(list(eq_pt), pt), *evals]
            self.multilinear_evals.append(evals)
            self.finish_rounds.append(self.round)
            vals = [cs.composition.evaluate_scalar(LEVEL, evals)
                    for cs in claim.composite_sums]
            self.sum ^= batch_weighted_value(coeff, vals)

    def receive_round_proof(self, transcript) -> None:
        deg = max((max(cs.composition.degree() for cs in c.composite_sums)
                   if c.composite_sums else 0 for c in self.claims), default=0)
        proof_coeffs = self._round_reader(transcript).read_scalars(LEVEL, deg)
        self._full = common.recover_full(proof_coeffs, self.sum)

    def finish_round(self, challenge: int) -> None:
        self.sum = common.eval_coeffs(self._full, challenge)
        self.round += 1
        self._reader = None

    def finish(self) -> None:
        if self.claims:
            raise ValueError("unfinished sumcheck claims")
        if self.sum != 0:
            raise ValueError("front-loaded sumcheck final sum is nonzero")

"""Front-loaded batched sumcheck (shared *early* challenges).

The port's copy of the parts of `binius_tpu/protocols/sumcheck/front_loaded.py`
that the PIOP reaches; it mirrors `crates/core/src/protocols/sumcheck/
front_loaded.rs` and `prove/front_loaded.rs`: claims sorted ascending by
n_vars all start at round 0; a claim with k variables finishes after round
k, at which point its multilinear evaluations enter the transcript and its
batched composite evaluation is subtracted from the running sum. One
batching coefficient per claim; composite claims inside a claim are mixed
by powers of it (`batch_weighted_value`, `sumcheck/common.rs:287`). Exposes
a round-by-round interface so the PIOP can interleave it with FRI folding.
The zerocheck's prebatched coefficients and eq-indicator evaluations are
not ported yet.
"""

from __future__ import annotations

from ...fields import scalar
from . import common
from .common import LEVEL


def batch_weighted_value(coeff: int, values: list[int]) -> int:
    """coeff * (v_0 + coeff*v_1 + coeff^2*v_2 + ...) — weight j+1 per value."""
    acc = 0
    for v in reversed(values):
        acc = scalar.mul(LEVEL, acc, coeff) ^ v
    return scalar.mul(LEVEL, coeff, acc)


def _degree(claims) -> int:
    return max((max(cs.composition.degree() for cs in c.composite_sums)
                if c.composite_sums else 0 for c in claims), default=0)


class FrontLoadedBatchProver:
    """Provers must be sorted ascending by n_vars, folding high to low."""

    def __init__(self, provers: list, transcript):
        assert all(provers[i].n_vars <= provers[i + 1].n_vars for i in range(len(provers) - 1))
        self.provers = list(provers)   # queue front = fewest vars
        self.coeffs = transcript.sample_scalars(LEVEL, len(provers))
        self.round = 0
        self.multilinear_evals: list = []  # claim-order final evals

    def _finish_ready(self, writer) -> None:
        while self.provers and self.provers[0].n_vars == self.round:
            p = self.provers.pop(0)
            self.coeffs.pop(0)
            evals = p.finish()
            writer.write_scalars(LEVEL, evals)
            self.multilinear_evals.append(evals)

    def send_round_proof(self, transcript) -> None:
        w = transcript.message()
        self._finish_ready(w)
        combined: list[int] = []
        for p, c in zip(self.provers, self.coeffs):
            wgt = c
            for coeffs_j in p.compute_round_polys():
                combined = common.add_coeffs(combined, common.scale_coeffs(coeffs_j, wgt))
                wgt = scalar.mul(LEVEL, wgt, c)
        deg = _degree([p.claim for p in self.provers])
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
    """Round-by-round verifier; claims ascending by n_vars."""

    def __init__(self, claims: list, transcript):
        assert all(claims[i].n_vars <= claims[i + 1].n_vars for i in range(len(claims) - 1))
        self.claims = list(claims)
        self.coeffs = transcript.sample_scalars(LEVEL, len(claims))
        self.sum = 0
        for claim, c in zip(self.claims, self.coeffs):
            self.sum ^= batch_weighted_value(c, [cs.sum for cs in claim.composite_sums])
        self.round = 0
        self.multilinear_evals: list = []
        self._reader = None

    def _round_reader(self, transcript):
        """EXACTLY one message reader per round (+ one post-loop), created
        unconditionally — the reference obtains `transcript.message()` before
        `try_finish_claim` every round (`front_loaded.rs:287-301`), and
        obtaining it transitions the challenger even when nothing is read.
        The prover's `send_round_proof`/`finish` writers mirror this."""
        if self._reader is None:
            self._reader = transcript.message()
        return self._reader

    def try_finish_claims(self, transcript) -> None:
        reader = self._round_reader(transcript)
        while self.claims and self.claims[0].n_vars == self.round:
            claim = self.claims.pop(0)
            coeff = self.coeffs.pop(0)
            evals = reader.read_scalars(LEVEL, claim.n_multilinears)
            self.multilinear_evals.append(evals)
            vals = [cs.composition.evaluate_scalar(LEVEL, evals)
                    for cs in claim.composite_sums]
            self.sum ^= batch_weighted_value(coeff, vals)

    def receive_round_proof(self, transcript) -> None:
        proof_coeffs = self._round_reader(transcript).read_scalars(LEVEL, _degree(self.claims))
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

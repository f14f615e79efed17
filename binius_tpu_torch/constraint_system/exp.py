"""Exponentiation phase of the constraint system.

The port of `binius_tpu/constraint_system/exp.py`: each `Exp` asserts that
a committed result column equals base^(bit-composed exponent) over
LSB-first B1 bit-column oracles, the base a public constant (static) or
another oracle (dynamic).

The phase, after the commit and before the zerocheck:
  1. sample `max_n_vars` challenge scalars;
  2. the prover writes each result column's evaluation at its prefix of
     the challenge;
  3. the GKR exponentiation (`protocols.gkr_exp`) walks the circuits down
     and leaves evalcheck claims on every bit column (and dynamic base);
  4. each result evaluation is also an evalcheck claim on its committed
     result oracle, which binds the committed column to the circuit's
     output (the JAX package's deliberate addition to the upstream
     protocol; the proof's bytes depend on it).

The prover computes the layer witnesses on its device
(`gkr_exp.ExpWitness`) at the base's level, from the bit columns unpacked
there.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fields import tower
from ..math import mle
from ..protocols import gkr_exp
from ..protocols.evalcheck import EvalcheckClaim
from ..protocols.sumcheck.common import LEVEL


@dataclasses.dataclass(frozen=True)
class Exp:
    """One exponentiation assertion. bits_ids: the exponent's bit-column
    oracles, LSB first; exactly one of base_const (static) and base_oracle
    (dynamic) is set; base_level: the base's (and the result's) level."""

    bits_ids: tuple
    exp_result_id: int
    base_level: int
    base_const: int | None = None
    base_oracle: int | None = None

    def __post_init__(self):
        assert (self.base_const is None) != (self.base_oracle is None)
        assert len(self.bits_ids) <= 1 << self.base_level

    def n_vars(self, oracles) -> int:
        return oracles[self.exp_result_id].n_vars

    def tokens(self) -> tuple:
        return ("exp", self.bits_ids, self.exp_result_id, self.base_level,
                self.base_const, self.base_oracle)


def reorder(exponents: list[Exp], oracles) -> list[Exp]:
    """Descending n_vars, static before dynamic (a dynamic base may be a
    static result)."""
    return sorted(exponents, key=lambda e: (-e.n_vars(oracles), e.base_const is None))


def max_n_vars(exponents: list[Exp], oracles) -> int:
    return max((e.n_vars(oracles) for e in exponents), default=0)


def make_exp_witnesses(system, witness: dict) -> list:
    """The layer witnesses of each exp, in `reorder`'s order, and the
    result columns (which the M3 user never fills) written into
    `witness`. Returns [ExpWitness]."""
    from . import witness as witness_mod
    out = []
    for e in reorder(system.exponents, system.oracles):
        n = e.n_vars(system.oracles)
        bit_datas = []
        for bid in e.bits_ids:
            lvl, data = witness_mod.materialize(system.oracles, witness, bid)
            assert lvl == 0, "exponent bits must be B1 columns"
            bit_datas.append(data)
        if e.base_const is not None:
            w = gkr_exp.ExpWitness.static(n, e.base_const, bit_datas, level=e.base_level)
        else:
            base = witness_mod.materialize(system.oracles, witness, e.base_oracle)
            w = gkr_exp.ExpWitness.dynamic(n, base, bit_datas, level=e.base_level)
        # a copy, so that the witness does not hold the whole layer stack
        witness[e.exp_result_id] = (e.base_level, w.result.clone())
        out.append(w)
    return out


def _make_claims(exponents, oracles, challenge, evals):
    claims = []
    for e, ev in zip(exponents, evals):
        n = e.n_vars(oracles)
        pt = tuple(challenge[:n])
        if e.base_const is not None:
            claims.append(gkr_exp.StaticExpClaim(n, len(e.bits_ids), e.base_const, pt, ev))
        else:
            claims.append(gkr_exp.DynamicExpClaim(n, len(e.bits_ids), pt, ev))
    return claims


def prove_phase(system, witness: dict, exp_witnesses: list, transcript) -> list:
    """The exp phase on the prover's transcript; returns evalcheck claims.
    `exp_witnesses` come from `make_exp_witnesses` (in its order)."""
    exponents = reorder(system.exponents, system.oracles)
    if not exponents:
        return []
    challenge = transcript.sample_scalars(LEVEL, max_n_vars(exponents, system.oracles))
    evals = _result_evals(exponents, system.oracles, witness, challenge)
    transcript.message().write_scalars(LEVEL, evals)
    claims = _make_claims(exponents, system.oracles, challenge, evals)
    out = gkr_exp.batch_prove(claims, exp_witnesses, transcript)
    return _eval_claims(exponents, system.oracles, challenge, evals, out)


def verify_phase(system, transcript) -> list:
    exponents = reorder(system.exponents, system.oracles)
    if not exponents:
        return []
    challenge = transcript.sample_scalars(LEVEL, max_n_vars(exponents, system.oracles))
    evals = transcript.message().read_scalars(LEVEL, len(exponents))
    claims = _make_claims(exponents, system.oracles, challenge, evals)
    out = gkr_exp.batch_verify(claims, transcript)
    return _eval_claims(exponents, system.oracles, challenge, evals, out)


def _eval_claims(exponents, oracles, challenge, evals, out: gkr_exp.ExpOutput) -> list:
    """Per exp: its result claim, then its bit claims, then its base claims."""
    ec = []
    for e, ev, bits, bases in zip(exponents, evals, out.bit_claims, out.base_claims):
        ec.append(EvalcheckClaim(e.exp_result_id, tuple(challenge[:e.n_vars(oracles)]), ev))
        for bi, pt, bev in bits:
            ec.append(EvalcheckClaim(e.bits_ids[bi], pt, bev))
        for pt, aev in bases:
            ec.append(EvalcheckClaim(e.base_oracle, pt, aev))
    return ec


def _result_evals(exponents, oracles, witness, challenge) -> list[int]:
    """Each result column at its challenge prefix: one batched evaluation
    per (level, n_vars) group."""
    groups: dict = {}
    for i, e in enumerate(exponents):
        lvl, _ = witness[e.exp_result_id]
        groups.setdefault((lvl, e.n_vars(oracles)), []).append(i)
    evals = [0] * len(exponents)
    for (lvl, n), idxs in groups.items():
        stack = torch.stack([witness[exponents[i].exp_result_id][1] for i in idxs])
        eq = mle.eq_ind_partial_eval(LEVEL, tower.from_ints(LEVEL, list(challenge[:n]),
                                                            stack.device))
        _, out = mle.batched_evaluate_partial_high(lvl, stack, n, eq, 0)
        for i, v in zip(idxs, tower.to_ints(LEVEL, out[:, 0])):
            evals[i] = v
    return evals

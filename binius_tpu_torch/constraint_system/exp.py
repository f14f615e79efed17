"""Exponentiation phase of the constraint system.

The port of the phase functions of `binius_tpu/constraint_system/exp.py`,
which the prover and the verifier call for every system. A system with no
exponents runs no exp phase and writes nothing; the GKR exponentiation
itself is not ported, so a system with exponents raises
`NotImplementedError`.
"""

from __future__ import annotations


def _refuse(system) -> None:
    if system.exponents:
        raise NotImplementedError("exponent constraints (the GKR exp phase) are not ported")


def make_exp_witnesses(system, witness: dict) -> list:
    """The exp-result witness columns the prover computes; none here."""
    _refuse(system)
    return []


def prove_phase(system, witness: dict, exp_witnesses: list, transcript) -> list:
    """The exp phase on the prover's transcript; returns evalcheck claims."""
    _refuse(system)
    return []


def verify_phase(system, transcript) -> list:
    _refuse(system)
    return []

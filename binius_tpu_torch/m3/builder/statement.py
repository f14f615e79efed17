"""M3 prove and verify with the table sizes in the proof.

The port of `binius_tpu/m3/builder/statement.py`: the prover writes the
tables' row counts as the proof's first message; the verifier reads them
back, compiles the system for those sizes (its step-down selectors
included) and verifies against it.
"""

from __future__ import annotations

from ...constraint_system import prove as csp


def m3_prove(m3_system, witness_index, boundaries: list = (), log_inv_rate: int = 1,
             device=None, group_claims: bool | None = None) -> bytes:
    """Prove an M3 system at its witness index's table sizes (on CUDA
    unless `device` names another; `group_claims` as `csp.prove`'s)."""
    sizes = witness_index.table_sizes
    core, omap = m3_system.compile_sizes(sizes)
    witness = witness_index.to_core_witness(core, omap, device)
    return csp.prove(core, witness, boundaries, log_inv_rate, table_sizes=sizes, device=device,
                     group_claims=group_claims)


def m3_verify(m3_system, proof: bytes, boundaries: list = (), log_inv_rate: int = 1,
              device=None) -> None:
    """Verify an M3 proof at the table sizes it carries."""
    sizes = csp.peek_table_sizes(proof)
    if len(sizes) != len(m3_system.tables):
        raise ValueError("proof table-size count does not match the system")
    core, _ = m3_system.compile_sizes(sizes)
    csp.verify(core, proof, boundaries, log_inv_rate, table_sizes=sizes, device=device)

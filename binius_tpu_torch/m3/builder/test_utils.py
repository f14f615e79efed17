"""M3 test utilities.

The port of `binius_tpu/m3/builder/test_utils.py`
(`crates/m3/src/builder/test_utils.rs:69-93`): a gadget's test validates
its witness directly; BINIUS_M3_TEST_PROVE_VERIFY=1 upgrades that to a
whole prove and verify, as the reference's integration job does.
"""

from __future__ import annotations

import os

from ...constraint_system import prove as csp
from ...constraint_system.system import validate_witness


def validate_system_witness(core_system, witness, boundaries=(), device=None) -> None:
    """Check the witness; with the flag set, also prove and verify it (on
    CUDA unless `device` names another)."""
    validate_witness(core_system, witness, boundaries)
    if os.environ.get("BINIUS_M3_TEST_PROVE_VERIFY") == "1":
        proof = csp.prove(core_system, witness, boundaries, device=device)
        csp.verify(core_system, proof, boundaries, device=device)

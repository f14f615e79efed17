"""binius_tpu_torch's proofs at code rates other than 1/2: the u32_add
system at 2^6 rows proven through the plain versions on the CPU with
`log_inv_rate` 2 and 3 has the JAX package's length and sha256
(`chip_smoke.GOLDEN_RATES_CPU`, from `scripts/port_golden_proof.py --circuit
u32_add --size 6 --log-inv-rate 2 3`), verifies at its rate and is
rejected at another."""

import hashlib

import pytest
import torch

import chip_smoke
from binius_tpu_torch import circuits
from binius_tpu_torch.constraint_system import prove as csp

torch.set_num_threads(1)  # the suite's test processes share the cores


@pytest.mark.parametrize("rate", [2, 3])
def test_u32_add_rate_matches_reference(rate):
    n_bytes, sha = chip_smoke.GOLDEN_RATES_CPU[("u32_add", 6, rate)]
    core, witness, stmt = circuits.instance("u32_add", 6, 0, "cpu")
    proof = csp.prove(core, witness, log_inv_rate=rate, device="cpu", **stmt)
    assert (len(proof), hashlib.sha256(proof).hexdigest()) == (n_bytes, sha)
    csp.verify(core, proof, log_inv_rate=rate, device="cpu", **stmt)
    with pytest.raises((ValueError, EOFError)):
        csp.verify(core, proof, log_inv_rate=rate - 1, device="cpu", **stmt)

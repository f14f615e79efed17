"""What the example command lines share: the device, a clock that waits for
the card, and the prove-and-verify loop that prints the metric lines."""

from __future__ import annotations

import time

import torch

from ..constraint_system import prove as csp
from ..constraint_system.system import validate_witness
from ..device import resolve

CPU_HELP = "run the plain PyTorch versions on the CPU instead of the kernels on the card"
VALIDATE_HELP = ("run the full witness semantic check before proving (skipped by default "
                 "above 2^16 rows)")
REPEAT_HELP = "prove this many fresh witnesses (run 1 is the first run, the rest warm)"


def device(cpu: bool) -> torch.device:
    """The CPU with --cpu, else the card; raises where there is none."""
    return resolve("cpu" if cpu else "cuda")


def header(what: str, dev: torch.device) -> None:
    """The first line: what is proven, on the device by name."""
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{what} on {name}", flush=True)


def clock(dev: torch.device) -> float:
    """Host seconds once the work queued on `dev` has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _ms(t0: float, t1: float) -> str:
    return f"{(t1 - t0) * 1e3:.1f} ms"


def trace_gen(build, dev: torch.device):
    """Build the instance (system, witness, statement) and print its time,
    the upstream `trace-gen-time`."""
    t0 = clock(dev)
    inst = build()
    print(f"trace-gen-time: {_ms(t0, clock(dev))}", flush=True)
    return inst


def validate(inst, dev: torch.device, print_time: bool = True) -> None:
    """Check the witness against every constraint (`validate_witness`)."""
    core, witness, stmt = inst
    t0 = clock(dev)
    validate_witness(core, witness, stmt.get("boundaries", ()))
    if print_time:
        print(f"validate-time: {_ms(t0, clock(dev))}", flush=True)


def prove_verify(inst, dev: torch.device, log_inv_rate: int, rebuild=None, repeat: int = 1,
                 phases: bool = True, verify: bool = True) -> bytes:
    """Prove `inst` and, for --repeat, `rebuild(i)` for runs i = 1.. (each
    built before its clock starts); print `prove-time` (tagged [first] and
    [warm] when there are several runs) and, with `phases`, each
    `prove.<phase>`; then the last proof's `proof-size` and, with `verify`,
    its `verify-time`. Returns the last proof."""
    for i in range(repeat):
        if i > 0:
            inst = rebuild(i)
        core, witness, stmt = inst
        t0 = clock(dev)
        proof = csp.prove(core, witness, log_inv_rate=log_inv_rate, device=dev, **stmt)
        t1 = clock(dev)
        tag = "" if repeat == 1 else f"[{'first' if i == 0 else 'warm'}]"
        print(f"prove-time{tag}: {_ms(t0, t1)}", flush=True)
        if phases:
            for k, v in csp.last_phase_times.items():
                if "/" not in k:   # the phases and the total, not the spans inside them
                    print(f"  prove.{k}: {v * 1e3:.1f} ms", flush=True)
    print(f"proof-size: {len(proof)} bytes", flush=True)
    if verify:
        t0 = clock(dev)
        csp.verify(core, proof, log_inv_rate=log_inv_rate, device=dev, **stmt)
        print(f"verify-time: {_ms(t0, clock(dev))}", flush=True)
    return proof

"""Process-group start-up for the sharded prover.

The port of `binius_tpu/parallel/distributed.py`. The JAX package runs one
controller per host over a global device mesh; here every rank is its own
process (SPMD over `torch.distributed`), holds its block of each large
multilinear and runs the same prover on it. The transcript is computed on
every rank from the same data, so the ranks stay in step without messages
beyond the mesh's collectives (`parallel/mesh.py`), and every rank ends with
the proof's bytes:

    from binius_tpu_torch.parallel import distributed, mesh
    distributed.initialize()            # under torchrun
    proof = prove(system, witness, mesh=mesh.make_mesh())

The backend is NCCL when the node has at least as many cards as local
ranks, one card per rank; otherwise gloo, on the CPU or for several ranks
sharing one card. NCCL has no bitwise reduction and refuses two ranks on
one card, and gloo has no `all_to_all` or send/recv on CUDA tensors, so
`mesh.py`'s collectives are all-gathers, all-to-alls and pairwise exchanges
that stage through host buffers under gloo.

`run_ranks` starts the ranks of one node from a running program (the tests,
`chip_smoke.py`): one process per rank by the `spawn` start method, on a
free local port, so nothing of CUDA is inherited from the caller.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve

_device: torch.device | None = None


def _env_int(name: str, default: int | None) -> int | None:
    v = os.environ.get(name)
    return default if v is None else int(v)


def local_world_size() -> int:
    """Ranks on this node (torchrun's LOCAL_WORLD_SIZE, else every rank)."""
    return _env_int("LOCAL_WORLD_SIZE",
                    dist.get_world_size() if dist.is_initialized() else 1)


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device=None) -> torch.device:
    """Join the process group and return this rank's device. With no
    arguments it reads torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK, LOCAL_RANK); otherwise pass `init_method`
    ("tcp://localhost:<port>"), `world_size` and `rank`.

    The device is `cuda:(local_rank % device_count)` unless `device` names
    the CPU; asking for CUDA without a card raises. `backend` defaults to
    NCCL when every local rank has a card of its own, else gloo."""
    global _device
    if world_size is None:
        world_size = _env_int("WORLD_SIZE", 1)
    if rank is None:
        rank = _env_int("RANK", 0)
    lrank = _env_int("LOCAL_RANK", rank)
    lsize = _env_int("LOCAL_WORLD_SIZE", world_size)
    dev = resolve(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", lrank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = ("nccl" if dev.type == "cuda" and torch.cuda.device_count() >= lsize
                   else "gloo")
    kw = {"backend": backend, "world_size": world_size, "rank": rank}
    if init_method is not None:
        kw["init_method"] = init_method
    dist.init_process_group(**kw)
    _device = dev
    return dev


def device() -> torch.device:
    """The device `initialize` chose for this rank."""
    if _device is None:
        raise RuntimeError("parallel.distributed.initialize has not run")
    return _device


def shutdown() -> None:
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def is_multi_host() -> bool:
    return dist.is_initialized() and dist.get_world_size() > local_world_size()


def local_device_fraction() -> tuple[int, int]:
    """(ranks on this node, ranks in all)."""
    total = dist.get_world_size() if dist.is_initialized() else 1
    return local_world_size(), total


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank: int, world_size: int, port: int, device, args, out) -> None:
    try:
        initialize(None, f"tcp://localhost:{port}", world_size, rank, device)
        out.put((rank, True, fn(*args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def run_ranks(fn, world_size: int, args: tuple = (), device=None,
              timeout: float = 600.0) -> list:
    """Run `fn(*args)` on `world_size` ranks of a new process group on this
    node and return their results in rank order. Each rank is a process
    started by the `spawn` method that joins the group on a free local port
    (`initialize` with `device`); `fn` must be importable by
    name (a module-level function) and its result picklable. Raises if a
    rank fails or `timeout` seconds pass; no rank outlives the call."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world_size, port, device, args, out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    ok = False
    try:
        while len(results) < world_size:
            try:
                rank, good, val = out.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: no result within {timeout} s") from None
                continue
            if not good:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{val}")
            results[rank] = val
        ok = True
    finally:
        for p in procs:
            if ok:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world_size)]

"""The benchmark of binius_tpu_torch: one cell, one run.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`workloads` in BENCHMARK.json) names a configuration and a traffic
mix; each is found by name: `port_bench/configs/<config>.json` and `.py`,
`port_bench/traffic/<traffic>.json`, and each metric's reader
`port_bench/metrics/<metric>.py`.

The traffic is a closed loop of one client, a batch prover draining a queue
of statements: each job takes a fresh statement (drawn from the seed and the
job's index), builds the witness through the program's front end, proves it
with `binius_tpu_torch.constraint_system.prove.prove`, and the next job
starts when the proof's bytes are on the host. Set-up imports the program,
loads its kernels, draws a pool of statements and runs the traffic's warm-up
jobs; the window then runs jobs until `--seconds` have passed (the job
running at that moment finishes). A window that uses up the pool ends the
run with no result, so that no statement is drawn inside it. The traffic
file sets the pool's size; the harness runs only a closed loop of one
client and refuses a traffic file that asks for another. With `--trace 1` the window is followed by
a few jobs under torch.profiler.

After the window the reference (`port_bench/reference`, plain Python and
NumPy, nothing of the program) verifies a sample of the window's proofs,
drawn from the seed, against the configuration's system at its security and
rate, and holds the values they claim for the committed columns against the
statement's own columns. The numbers compared are printed with their limits
as the last lines of standard error and under "checks", the result line's
last key. The result is the last line of standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

BANNED_MODULES = ("jax", "jaxlib", "flax", "binius_tpu")
WARM_INDEX = 1 << 40       # statements of the warm-up jobs
PROFILE_INDEX = 1 << 41    # statements of the profiled jobs
OTHER_INDEX = 1 << 42      # a fault's foreign rows


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    module: object
    traffic: dict
    chips: int
    log_size: int

    @staticmethod
    def find(bench: dict, name: str, log_size: int | None = None) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
        w = cells[name]
        entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        with open(ROOT / entry["file"]) as f:
            config = json.load(f)
        module = load_file(BENCH_DIR / "configs" / f"{w['config']}.py",
                           f"port_bench_config_{w['config'].replace('.', '_')}")
        with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
            traffic = json.load(f)
        if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
            raise SystemExit(f"traffic {w['traffic']!r}: loop {traffic.get('loop')!r}, clients "
                             f"{traffic.get('clients')!r}; the harness runs only a closed loop "
                             f"of one client")
        return Cell(name, config, module, traffic, int(w["chips"]),
                    config["log_size"] if log_size is None else log_size)


@dataclasses.dataclass
class Job:
    index: int
    frontend_s: float = 0.0
    prove_s: float = 0.0
    phases: dict = dataclasses.field(default_factory=dict)
    stages: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    proof: bytes | None = None
    error: str | None = None


@dataclasses.dataclass
class Run:
    """What a metric's reader gets."""
    cell: Cell
    seed: int
    setup_s: float
    window_s: float
    jobs: list            # the window's jobs
    profiled: list        # the traced stretch's jobs (trace runs)
    profiled_s: float     # the traced stretch's host seconds
    trace: object         # device_trace.TraceSummary or None
    judged_wrong: int = 0

    @property
    def completed(self) -> int:
        return sum(j.error is None for j in self.jobs) - self.judged_wrong


class Prover:
    """The system under test behind one call per job: the configuration's
    front end, then `prove`, with the program's phase and stage times and
    kernel launch counts read after each proof. `faults` (tests and the
    control only) break the timed path underneath."""

    def __init__(self, cell: Cell, device, faults=()):
        from binius_tpu_torch import cuda_lib
        from binius_tpu_torch.constraint_system import prove as csp
        from binius_tpu_torch.protocols.sumcheck import univariate_zerocheck as uzc
        self.cell, self.device, self.faults = cell, device, set(faults)
        self.csp, self.uzc, self.cuda_lib = csp, uzc, cuda_lib
        self._last_proof = None
        self._saved_bits = csp.SECURITY_BITS
        if "low_security" in self.faults:
            csp.SECURITY_BITS = self._saved_bits - 20

    def close(self) -> None:
        self.csp.SECURITY_BITS = self._saved_bits

    def _sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def job(self, index: int, stmt: dict, seed: int) -> Job:
        import torch
        cfg, mod = self.cell.config, self.cell.module
        out = Job(index)
        if "half_batch" in self.faults:
            other = mod.draw(self.cell.log_size, seed, OTHER_INDEX + index)
            stmt = {k: _half_and_half(v, other[k]) for k, v in stmt.items()}
        self.cuda_lib.reset_launches()
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("frontend"):
                system, witness = mod.build(stmt, self.cell.log_size, self.device)
                self._sync()
            t1 = time.perf_counter()
            proof = self.csp.prove(system, witness, log_inv_rate=cfg["log_inv_rate"],
                                   device=self.device)
            t2 = time.perf_counter()
        except Exception as exc:  # a job that fails counts in `failed`
            out.error = f"{type(exc).__name__}: {exc}"
            log(f"job {index} failed: {out.error}")
            return out
        del system, witness
        if "flip_byte" in self.faults:
            pos = random.Random(index).randrange(len(proof))
            proof = proof[:pos] + bytes([proof[pos] ^ 1]) + proof[pos + 1:]
        if "stale_proof" in self.faults and self._last_proof is not None:
            proof, self._last_proof = self._last_proof, proof
        else:
            self._last_proof = proof
        out.frontend_s, out.prove_s = t1 - t0, t2 - t1
        out.phases = dict(self.csp.last_phase_times)
        out.stages = dict(self.uzc.last_stage_times)
        out.launches = dict(self.cuda_lib.launches)
        out.proof = proof
        return out


def _half_and_half(a, b):
    """The first half of a's rows, then the second half of b's."""
    import numpy as np
    n = a.shape[0] // 2
    return np.concatenate([a[:n], b[n:]])


def host_lines(device) -> None:
    """The card, the host and a fixed host micro-timing: lines, not metrics."""
    import torch
    from reference import field
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=30).stdout.strip().splitlines()
        except (OSError, subprocess.SubprocessError) as exc:
            smi = [f"nvidia-smi: {exc}"]
        log(f"card: {name} x {torch.cuda.device_count()}; nvidia-smi: {' | '.join(smi)}")
    a, b = 0x2E895399AF449ACE499596F6E5FCCAFA, 0x8000000080008081_0000000000008082
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(2000):
            a = field.mul(a, b) | 1
        times.append((time.perf_counter() - t0) / 2000 * 1e6)
    log(f"host: {os.cpu_count()} cores; B128 product (plain Python, the reference's): "
        f"{statistics.median(times):.3f} us")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             faults=()) -> tuple[dict, list]:
    """One run of a cell: returns (result, the window's jobs). `device` is
    the card in a benchmark run; tests pass the CPU."""
    import torch
    from binius_tpu_torch import cuda_lib, native
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)   # the context, before its memory counters
        cuda_lib.lib()
        torch.cuda.reset_peak_memory_stats(device)
    native.get_lib()
    host_lines(device)
    traffic = cell.traffic
    pool = [cell.module.draw(cell.log_size, seed, i) for i in range(traffic["pool"])]
    prover = Prover(cell, device, faults)
    try:
        for k in range(traffic["warm_jobs"]):
            w = prover.job(WARM_INDEX + k, cell.module.draw(cell.log_size, seed, WARM_INDEX + k),
                           seed)
            if w.error:
                raise RuntimeError(f"warm-up job failed: {w.error}")
        setup_s = time.perf_counter() - T_START

        jobs = []
        t0 = time.perf_counter()
        while not jobs or time.perf_counter() - t0 < seconds:
            i = len(jobs)
            if i == len(pool):
                raise SystemExit(f"the pool of {len(pool)} statements ran out after "
                                 f"{time.perf_counter() - t0:.1f} s of the window; a faster "
                                 f"program needs a traffic mix with a larger pool")
            jobs.append(prover.job(i, pool[i], seed))
        window_s = time.perf_counter() - t0
        del pool

        profiled, profiled_s, summary = [], 0.0, None
        if trace:
            from device_trace import summarize
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            stmts = [cell.module.draw(cell.log_size, seed, PROFILE_INDEX + k)
                     for k in range(traffic["profile_jobs"])]
            with torch.profiler.profile(activities=acts) as prof:
                t1 = time.perf_counter()
                for k, stmt in enumerate(stmts):
                    profiled.append(prover.job(PROFILE_INDEX + k, stmt, seed))
                profiled_s = time.perf_counter() - t1
            summary = summarize(prof)
            del prof
    finally:
        prover.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell, seed, setup_s, window_s, jobs, profiled, profiled_s, summary)
    checks, run.judged_wrong = reference_check(run, device)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = read_metrics(run, trace)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": len(jobs) + len(profiled),
              "failed": sum(j.error is not None for j in jobs + profiled) + run.judged_wrong,
              "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = profiled_s
        top = sorted(summary.device_s_by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(summary.idle_s_by_range.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                               "idle_gaps": [[k, v] for k, v in gaps]}
    result["checks"] = checks
    return result, jobs


def reference_check(run: Run, device) -> tuple[dict, int]:
    """The reference on a sample of the window's proofs, drawn from the
    seed: each verified at the configuration's security and rate, and its
    committed columns' claimed values held against the statement's own.
    Returns the numbers compared, each with its limit, and the number of
    proofs judged wrong."""
    from reference import binding, verifier
    cell, cfg = run.cell, run.cell.config
    system = cell.module.reference_system(cell.log_size, bytes.fromhex(cfg["system_digest"]))
    done = [j for j in run.jobs if j.error is None]
    sample = sorted(random.Random(run.seed).sample(done, min(cfg["check_proofs"], len(done))),
                    key=lambda j: j.index)
    rejected = mismatched = wrong = 0
    t0 = time.perf_counter()
    for j in sample:
        try:
            claims = verifier.verify(system, j.proof, cfg["security_bits"], cfg["log_inv_rate"])
        except verifier.Rejected as exc:
            log(f"reference: proof of job {j.index} rejected: {exc}")
            rejected += 1
            wrong += 1
            continue
        cols, log_width = cell.module.reference_columns(
            cell.module.draw(cell.log_size, run.seed, j.index))
        bad = binding.mismatches(claims, cols, log_width, device)
        if bad:
            log(f"reference: job {j.index}: {bad} of {len(claims)} committed values differ "
                f"from the statement's columns")
        mismatched += bad
        wrong += bool(bad)
    log(f"reference: {len(sample)} of {len(done)} proofs checked in "
        f"{time.perf_counter() - t0:.1f} s")
    failed = sum(j.error is not None for j in run.jobs + run.profiled)
    return {"jobs_failed": {"value": failed, "limit": 0},
            "proofs_rejected": {"value": rejected, "limit": 0},
            "claims_mismatched": {"value": mismatched, "limit": 0}}, wrong


def read_metrics(run: Run, trace: bool) -> dict:
    """Each metric of the cell by its reader, `port_bench/metrics/<name>.py`:
    the end-to-end metrics without tracing, the per-layer ones with it. A
    reader that finds nothing to read returns None and its metric is left
    out."""
    bench = load_bench()
    wanted = bench["per_layer"] if trace else bench["end_to_end"]
    out = {}
    for m in wanted:
        reader = load_file(BENCH_DIR / "metrics" / f"{m['name']}.py",
                           f"port_bench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED_MODULES))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell.find(load_bench(), args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"))
    found = banned_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

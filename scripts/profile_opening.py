"""Profile one warm opening of the u32_add commitment, or one warm proof of
a circuit, on the card.

    python3 scripts/profile_opening.py [--log-rows 22] [--seed 0] [--k1-designs]
    python3 scripts/profile_opening.py --proof [--circuit u32_add] [--log-rows N] [--seed 0]
    python3 scripts/profile_opening.py --against parent


Builds the instance of `chip_smoke.py` (the u32_add witness, one claim per
column at the point drawn after it), runs one opening as a warm-up, then
one under `torch.profiler` (CPU and CUDA activities). Prints the card
(nvidia-smi name and power limit), the opening's wall time (host clock
around work that ends in `torch.cuda.synchronize()`), the device time by
kernel name (sum, calls, mean), the sum over all device kernels and the
device's idle share of the wall time (one stream, so kernels do not
overlap), the port's launch counts for the same opening, K1's launches
by level and batch size with their device time, and each launch of K3
and K4 (stages, words), K5 (leaves, blob bytes, kernel) and K6 (pairs,
kernel: one wide level or the tail to the root) with its device time. A launch's device time comes from the profiler's events of
its kernel, matched in order to the launches the wrappers made. The torch
ops whose kernels take the most device time are listed with their input
shapes (the profiler records shapes), which names the call sites.

--against DIR compares two trees on one card: DIR holds another checkout
of the repo (for example `git archive <commit>` unpacked into `parent/`,
which .gitignore lists); this script is copied into it and run there and
here, each in a process of its own, in the order DIR, here, here, DIR.

--proof profiles the whole proof instead (`constraint_system.prove.prove`
on `circuits.instance(circuit, log-rows, seed)`, as `chip_smoke.py` proves
it: u32_add, b32_mul, keccak, groestl, u32_mul_gkr, bitwise_ops or
keccak_lookups, sha256, merkle_tree, u32_sub, u32_mul, barrel_shifter or
div_uu32, 2^log-rows rows, products, permutations, compressions,
divisions or leaves, by default the circuit's grid size
or `circuits.CARD_SIZE`, with the instance's boundaries and table sizes).
It first prints the first proof's length and peak device memory, the
warm proof's wall time and phases (median of 3) and the verify time, the
latter also with the evalcheck's shift indicators checked one claim at a
time where the tree stacks them; the profile then adds the device
time by op family (the six kernels, torch gathers, copies and
concatenations, reductions, float64 GEMMs, other elementwise kernels,
fills) and, per prove phase (the prover's "prove.<phase>" profiler
ranges, each ending in a synchronize), its wall time, the device time of
the kernels that start inside it and its idle share; the zerocheck's
three stages ("zerocheck.stage<i>" ranges, each ending in a copy to the
host) the same way; then one more warm proof under cProfile for the host's
share: the functions with the most own time and the transcript's Grøstl.

--k1-designs profiles two more openings, one with every B128 product on
K1's one-tile-per-block kernel and one with every B128 product on its
persistent kernel (`bitslice_cuda.B128_PERSISTENT_FROM` set to never and
to always), and prints K1's device time by size for all three.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
import time

import torch


def warm_and_verify(csp, core, witness, stmt) -> None:
    """The proof's warm wall time and phases (median of 3, after one
    warm-up), then its verify time (median of 3). Where the evalcheck
    verifier checks a wave's shift indicators as one stacked carry DP
    (`shift_ind.evaluate_scalar_batch`), verify is timed again with each
    claim checked alone by the scalar DP (`shift_ind.evaluate_scalar`), with
    the seconds spent in those checks."""
    import statistics

    from binius_tpu_torch.protocols import shift_ind

    torch.cuda.reset_peak_memory_stats()
    proof = csp.prove(core, witness, **stmt)
    torch.cuda.synchronize()
    print(f"proof: {len(proof)} bytes, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = csp.prove(core, witness, **stmt)
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t0) * 1e3, dict(csp.last_phase_times)))
        if again != proof:
            raise AssertionError("proof bytes differ between runs")
    wall = statistics.median(r[0] for r in runs)
    print("warm proof, median of 3: %.3f ms (phases ms: %s)" % (wall, ", ".join(
        f"{k} {statistics.median(r[1][k] for r in runs) * 1e3:.3f}" for k in runs[0][1])),
        flush=True)
    batch = getattr(shift_ind, "evaluate_scalar_batch", None)
    ways = {"stacked": batch} if batch else {"as the tree has it": None}
    if batch:
        ways["one claim at a time"] = lambda vs, bs, offs, xs, ys, device=None: [
            shift_ind.evaluate_scalar(*c) for c in zip(vs, bs, offs, xs, ys)]
    for label, fn in ways.items():
        spent = [0.0]
        if fn:
            def timed(*a, fn=fn, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                spent[0] += time.perf_counter() - t0
                return out
            shift_ind.evaluate_scalar_batch = timed
        times, checks = [], []
        for _ in range(3):
            spent[0] = 0.0
            t0 = time.perf_counter()
            csp.verify(core, proof, **stmt)
            times.append((time.perf_counter() - t0) * 1e3)
            checks.append(spent[0] * 1e3)
        print(f"verify, shift indicators {label}, median of 3: {statistics.median(times):.3f} "
              f"ms" + (f" (shift checks {statistics.median(checks):.3f} ms)" if fn else ""),
              flush=True)
    if batch:
        shift_ind.evaluate_scalar_batch = batch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-rows", type=int, default=None,
                    help="log2 of the rows, products or permutations (default: 22, or "
                         "the circuit's grid size with --proof)")
    ap.add_argument("--circuit", default="u32_add",
                    choices=("u32_add", "b32_mul", "keccak", "groestl", "u32_mul_gkr",
                             "bitwise_ops", "keccak_lookups", "sha256", "merkle_tree",
                             "u32_sub", "u32_mul", "barrel_shifter", "div_uu32"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--k1-designs", action="store_true")
    ap.add_argument("--proof", action="store_true")
    ap.add_argument("--against", metavar="DIR")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if args.log_rows is None:
        from binius_tpu_torch import circuits
        sizes = {**circuits.GRID_SIZE, **getattr(circuits, "CARD_SIZE", {})}
        args.log_rows = sizes[args.circuit] if args.proof else 22
    if args.against:
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        other = os.path.abspath(args.against)
        shutil.copy(os.path.abspath(__file__), os.path.join(other, "scripts", "profile_opening.py"))
        rc = 0
        for label, root in (("parent", other), ("change", here), ("change", here),
                            ("parent", other)):
            print(f"==== {label}: {root}", flush=True)
            rc |= subprocess.run([sys.executable, os.path.join(root, "scripts", "profile_opening.py"),
                                  "--log-rows", str(args.log_rows), "--seed", str(args.seed),
                                  "--top", str(args.top)] + ["--proof"] * args.proof
                                 + ["--circuit", args.circuit] * (args.circuit != "u32_add"),
                                 cwd=root).returncode
        return rc
    if not torch.cuda.is_available():
        print("profile_opening: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from binius_tpu_torch import cuda_lib
    from binius_tpu_torch.fields import bitslice_cuda
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.proof:
        from binius_tpu_torch.constraint_system import prove as csp

        what = f"{args.circuit} proof"
        stmt = {}
        if args.circuit == "u32_add":   # as circuits.instance builds it (older trees lack it)
            from binius_tpu_torch.m3.gadgets import arith
            core, witness = arith.u32_add_system(
                args.log_rows, *arith.u32_add_rows(args.log_rows, args.seed), dev)
        else:
            from binius_tpu_torch import circuits
            got = circuits.instance(args.circuit, args.log_rows, args.seed, dev)
            core, witness = got[:2]
            if len(got) > 2:   # the statement (boundaries, table sizes), where the tree has it
                stmt = got[2]

        def run():
            proof = csp.prove(core, witness, **stmt)
            print("phases (s): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                            csp.last_phase_times.items()), flush=True)
            return proof

        warm_and_verify(csp, core, witness, stmt)
    else:
        what = "opening"
        inst = chip_smoke.instance(args.log_rows, args.seed, dev)

        def run():
            return chip_smoke.open_commitment(inst)

    # the launches of K1 and K3-K6 in order: (wrapper name, arguments)
    calls = []
    launch = cuda_lib.call

    def recording_call(name, *args):
        if name[:2] in ("k1", "k3", "k4", "k5", "k6"):
            calls.append((name, args))
        launch(name, *args)

    cuda_lib.call = recording_call

    def profiled_opening():
        run()   # warm-up: build, plans, tables
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        calls.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms, dict(cuda_lib.launches), list(calls)

    # device kernel names of each wrapper's kernels (this tree's and its
    # parents': K4 was one launch per stage, K5 one kernel, K6 one launch per
    # level)
    kernel_names = {"k1": r"\bmul(128)?_kernel\b", "k3": r"\bntt_local_kernel\b",
                    "k4": r"\bntt_(pair|cross)_kernel\b", "k5": r"\bleaf\w*_kernel\b",
                    "k6": r"\b(pairs|tail)_kernel\b"}

    def matched(prof, calls, k):
        """[(launch arguments, device event)] of wrapper k's launches."""
        evs = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
                      and re.search(kernel_names[k], ev.name)),
                     key=lambda ev: ev.time_range.start)
        mine = [args for name, args in calls if name[:2] == k]
        if len(evs) != len(mine):
            print(f"{k.upper()}: {len(evs)} device events for {len(mine)} launches; not matched")
            return []
        return list(zip(mine, evs))

    def k1_by_size(prof, calls):
        """{(level, log2 n): [launches, device us]} from K1's device events."""
        sizes = collections.defaultdict(lambda: [0, 0.0])
        for (_, _, _, level, n, *_), ev in matched(prof, calls, "k1"):
            row = sizes[(level, n.bit_length() - 1)]
            row[0] += 1
            row[1] += ev.time_range.elapsed_us()
        return sizes

    def per_launch(prof, calls):
        """Each launch of K3, K4, K5 and K6 with its device time."""
        k3, k4, k5, k6 = (matched(prof, calls, k) for k in ("k3", "k4", "k5", "k6"))
        print("K3 launches (stages, words, groups, device us):")
        for args, ev in k3:
            print(f"  {args[3]} stages, {args[4]} words, {args[5]} groups: "
                  f"{ev.time_range.elapsed_us():.2f}")
        print("K4 launches (stages per launch, lowest word distance, device us):")
        for args, ev in k4:
            stages = args[5] if len(args) > 6 else 1  # k4_ntt_pair ran one stage
            dist = 1 << args[4] if len(args) > 6 else args[4]
            print(f"  {stages} stages from word distance {dist}: {ev.time_range.elapsed_us():.2f}")
        print("K5 launches (leaves x blob bytes, kernel, device us):")
        for args, ev in k5:
            kernel = re.search(kernel_names["k5"], ev.name).group(0)
            print(f"  {args[1]} x {args[2] * 8} B, {kernel}: {ev.time_range.elapsed_us():.2f}")
        print("K6 launches (pairs, kernel: device us): " + ", ".join(
            f"{args[1]} {re.search(kernel_names['k6'], ev.name).group(1)}: "
            f"{ev.time_range.elapsed_us():.2f}" for args, ev in k6))
        for k, launches in (("K3", k3), ("K4", k4), ("K5", k5), ("K6", k6)):
            us = sum(ev.time_range.elapsed_us() for _, ev in launches)
            print(f"{k} device ms over its launches: {us / 1e3:.4f}")

    def host_functions(fn):
        """One more warm run under cProfile: the host seconds of the
        functions with the most own time, and of the transcript's Grøstl
        (`hash.groestl.Groestl256.update` and `finalize`, with what they
        call), with the blocks they compress (counted around
        `compress_seq_native` and `_digest_cols`)."""
        import cProfile
        import pstats

        from binius_tpu_torch.hash import groestl
        blocks = [0]

        def counted(f):
            def call(h, data):
                blocks[0] += len(data) // 64
                return f(h, data)
            return call

        seq, digest = groestl.compress_seq_native, groestl._digest_cols
        groestl.compress_seq_native, groestl._digest_cols = counted(seq), counted(digest)
        pr = cProfile.Profile()
        t0 = time.perf_counter()
        try:
            pr.runcall(fn)
            torch.cuda.synchronize()
        finally:
            groestl.compress_seq_native, groestl._digest_cols = seq, digest
        wall = time.perf_counter() - t0
        st = pstats.Stats(pr)
        rows_ = sorted(((v[2], v[3], v[1], f) for f, v in st.stats.items()), reverse=True)
        print(f"host under cProfile: wall {wall * 1e3:.1f} ms; functions by own time "
              f"(own s, with callees s, calls):")
        for own, cum, calls, (file, line, name) in rows_[:args.top]:
            print(f"  {own:8.4f} {cum:8.4f} {calls:8d}  {os.path.basename(file)}:{line}({name})")
        grs = [(v[3], v[1]) for (file, _, name), v in st.stats.items()
               if name in ("update", "finalize") and file.endswith("groestl.py")]
        print(f"transcript Grøstl (Groestl256.update and finalize): "
              f"{sum(c for c, _ in grs):.4f} s in {sum(n for _, n in grs)} calls, "
              f"{blocks[0]} compressions")

    def families(kernels):
        """Device ms by op family, from the device kernels' names."""
        fams = [("K1-K6", "|".join(kernel_names.values())),
                ("gather / index", r"index|[Gg]ather|Index"),
                ("copy / cat", r"CatArray|[Cc]opy"),
                ("reduce", r"[Rr]educe"),
                ("float64 GEMM", r"gemm|cutlass|xmma|dot"),
                ("fill", r"[Ff]ill"),
                ("other elementwise", r"elementwise|Elementwise")]
        sums = collections.defaultdict(lambda: [0.0, 0])
        for ms, count, key in kernels:
            fam = next((f for f, pat in fams if re.search(pat, key)), "other")
            sums[fam][0] += ms
            sums[fam][1] += count
        print("device ms by op family (kernels):")
        for fam, (ms, count) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
            print(f"  {fam:20s} {ms:10.3f} ({count} kernels)")

    def per_phase(prof):
        """Wall ms, device ms and idle share of each prove phase."""
        dev_evs = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
                   and not ev.name.startswith(("prove.", "zerocheck."))]
        print(f"{'phase':>16} {'wall ms':>10} {'device ms':>10} {'idle':>7}")
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA or not ev.name.startswith(("prove.",
                                                                             "zerocheck.")):
                continue
            lo, hi = ev.time_range.start, ev.time_range.end
            busy = sum(d.time_range.elapsed_us() for d in dev_evs
                       if lo <= d.time_range.start < hi) / 1e3
            wall = (hi - lo) / 1e3
            print(f"{ev.name.removeprefix('prove.'):>16} {wall:10.3f} {busy:10.3f} "
                  f"{1 - busy / wall if wall else 0:7.4f}")

    # (a name of its own: `recording_call` appends to `calls`, and the
    # cProfile run below launches more)
    prof, wall_ms, launches, profiled_calls = profiled_opening()

    # the device's own events (kernels, copies, fills), not the host ops
    # that launched them, nor the device spans of the prover's phase ranges
    kernels = [(ev.self_device_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
               and not ev.key.startswith(("prove.", "zerocheck."))]
    kernels.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in kernels)
    print(f"{what} 2^{args.log_rows} under the profiler: wall {wall_ms:.3f} ms, device "
          f"kernels {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}")
    print(f"launches (port counters): {launches}")
    print(f"{'device ms':>10} {'calls':>6} {'mean us':>9}  kernel")
    for ms, count, key in kernels[:args.top]:
        print(f"{ms:10.3f} {count:6d} {ms / count * 1e3:9.2f}  {key[:110]}")

    if args.proof:
        families(kernels)
        per_phase(prof)
        host_functions(run)
    # the torch ops whose kernels take the most device time, by input shape
    ops = [(ev.device_time_total / 1e3, ev.count, ev.key, ev.input_shapes)
           for ev in prof.key_averages(group_by_input_shape=True)
           if ev.device_type == DeviceType.CPU and ev.key.startswith("aten::")
           and ev.device_time_total > 0]
    ops.sort(key=lambda t: -t[0])
    print("torch ops by device ms (their kernels), with input shapes:")
    for ms, count, key, shapes in ops[:12]:
        print(f"{ms:10.3f} {count:6d}  {key} {str(shapes)[:90]}")

    per_launch(prof, profiled_calls)

    runs = {f"as run (B128 persistent from {bitslice_cuda.B128_PERSISTENT_FROM})":
            k1_by_size(prof, profiled_calls)}
    if args.k1_designs:
        split = bitslice_cuda.B128_PERSISTENT_FROM
        for label, start in (("B128 all one tile per block", 1 << 62),
                             ("B128 all persistent", 0)):
            bitslice_cuda.B128_PERSISTENT_FROM = start
            prof, wall_ms, _, profiled_calls = profiled_opening()
            runs[label] = k1_by_size(prof, profiled_calls)
        bitslice_cuda.B128_PERSISTENT_FROM = split
    keys = sorted({k for sizes in runs.values() for k in sizes})
    print("K1 device us by level and batch size 2^k <= n < 2^(k+1) (launches):")
    print(f"{'level':>5} {'k':>3}  " + "  ".join(f"{label:>30}" for label in runs))
    for key in keys:
        print(f"{key[0]:5d} {key[1]:3d}  " + "  ".join(
            f"{sizes[key][1]:22.2f} ({sizes[key][0]:5d})" if key in sizes else f"{'-':>30}"
            for sizes in runs.values()))
    print(f"{'K1 ms':>11}  " + "  ".join(
        f"{sum(us for _, us in sizes.values()) / 1e3:30.4f}" for sizes in runs.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

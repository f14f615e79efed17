"""The program's spans and counters as the benchmark reads them: a traced
run of u32_add at 2^8 rows on the CPU reports the six metrics read from
`last_phase_times` and `utils.tracing.counters()`, the front end's three
spans within the benchmark's own span around them; against a program
without those spans and counters, the readers report nothing."""

import json
import subprocess
import sys
import textwrap

import run as bench_run

NEW = ("frontend.compile_ms", "frontend.witness_ms", "frontend.to_device_ms",
       "evalcheck.walk_ms", "transcript_ms", "readbacks")


def test_traced_run_reads_the_spans():
    code = textwrap.dedent("""
        import sys, json, torch
        sys.path[:0] = ["port_bench"]
        import run
        cell = run.Cell.find(run.load_bench(), "u32_add.grid", log_size=8)
        cell.traffic = dict(cell.traffic, pool=4, profile_jobs=1)
        result, jobs = run.run_cell(cell, 2 ** 33 + 5, 0.1, True, torch.device("cpu"))
        print(json.dumps([result["correct"], result["metrics"]]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=bench_run.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    for name in NEW:
        assert metrics[name]["value"] > 0, name
    assert metrics["readbacks"]["unit"] == "count"
    assert metrics["readbacks"]["value"] == int(metrics["readbacks"]["value"])
    front = sum(metrics[f"frontend.{k}_ms"]["value"] for k in ("compile", "witness", "to_device"))
    assert front <= metrics["frontend_ms"]["value"]
    assert metrics["evalcheck.walk_ms"]["value"] <= metrics["evalcheck_ms"]["value"]


def test_readers_report_nothing_without_spans(monkeypatch):
    """The tree before the spans: `last_phase_times` holds the phases only
    and `utils.tracing` has no `counters`."""
    from binius_tpu_torch.utils import tracing
    monkeypatch.delattr(tracing, "counters")
    cell = bench_run.Cell.find(bench_run.load_bench(), "u32_add.grid", log_size=8)
    job = bench_run.Job(0, phases={"commit": 0.1, "evalcheck": 0.1, "total": 0.3}, proof=b"")
    run = bench_run.Run(cell, 1, 1.0, 1.0, [job], [], 0.0, None)
    for name in NEW:
        reader = bench_run.load_file(bench_run.BENCH_DIR / "metrics" / f"{name}.py", name)
        assert reader.read(run) is None, name

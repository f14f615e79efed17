"""The port's span tracing (`utils/tracing.py`) and the prover's bytes per
phase on the CPU.

Spans nest into a per-proof table keyed by their path, which `prove`
publishes as `last_phase_times` (the front end's spans in the next proof's
table); they open profiler ranges only under an enabled profiler, each
named with a prefix the benchmark's device trace labels idle gaps by; the
Chrome file (BINIUS_TRACE_FILE) is stamped on the profiler's clock; the
"readbacks" counter counts per proof and per phase. The golden 8-row
u32_add proof's `last_phase_sizes` equal the JAX package's (pinned in
`chip_smoke.GOLDEN_PHASE_SIZES_8` from `scripts/port_golden_proof.py
--circuit golden_8`) and sum to its 7,328 bytes, and with tracing on the
proof's trace holds one complete span per phase, of the phase's time."""

import atexit
import importlib
import json
import sys
import time
from pathlib import Path

import pytest
import torch

import chip_smoke
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.utils import tracing

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "port_bench"))
import device_trace  # noqa: E402  (the benchmark's reader of a device trace)

torch.set_num_threads(1)  # the suite's test processes share the cores

PHASES = {"commit", "exp", "gpa", "zerocheck", "evalcheck", "ring_switch", "piop", "total"}


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """The tracing module reloaded with BINIUS_TRACE_FILE set; restored
    afterwards."""
    out = tmp_path / "trace.json"
    monkeypatch.setenv("BINIUS_TRACE_FILE", str(out))
    monkeypatch.setenv("BINIUS_TRACE_PHASES", "0")
    tr = importlib.reload(tracing)
    yield tr, out
    atexit.unregister(tr.save)
    monkeypatch.delenv("BINIUS_TRACE_FILE")
    importlib.reload(tracing)


def _profiled(fn, path: Path) -> list:
    """The "user_annotation" events of a CPU torch.profiler session around
    fn(), exported to `path`, with the session's base time (ns) beside
    each."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    return [dict(e, base_ns=base) for e in data["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_span_export(traced):
    tr, out = traced
    assert tr.enabled()
    with tr.span("outer", root=True):
        with tr.span("inner"):
            with tr.span("hashing", hot=True):
                pass
    with tr.span("phase", range="prove.phase", root=True):
        pass
    tr.save(str(out))
    data = json.loads(out.read_text())
    names = [e["name"] for e in data["traceEvents"]]
    assert names == ["outer/inner", "outer", "prove.phase"]
    assert {e["ph"] for e in data["traceEvents"]} == {"X"}
    assert all(e["dur"] >= 0 for e in data["traceEvents"])
    assert data["displayTimeUnit"] == "ms"
    table = tr.publish()
    assert set(table) == {"outer", "outer/inner", "outer/hashing", "phase"}


def test_disabled_spans_record_nothing(monkeypatch):
    monkeypatch.delenv("BINIUS_TRACE_FILE", raising=False)
    monkeypatch.delenv("BINIUS_TRACE_PHASES", raising=False)
    tr = importlib.reload(tracing)
    assert not tr.enabled()
    tr.publish()
    with tr.span("root", root=True):
        pass
    assert tr._events == []
    # a span outside every root (a verifier's walk, a protocol's test)
    # times itself and records nothing, nor do its children or counts
    with tr.span("walk") as s:
        with tr.span("sumcheck.round"):
            with tr.span("transcript", hot=True):
                tr.count("readbacks")
    assert s.seconds > 0
    assert tr._events == []
    assert set(tr.publish()) == {"root"}
    assert "readbacks" not in tr.counters()


def test_span_paths_and_publish():
    """Nested spans are keyed by their path; `prove` publishes every span
    closed since the proof before, the front end's among them, and keys
    without "/" are the phases and the total."""
    tracing.publish()
    with tracing.span("a", root=True):
        with tracing.span("b"):
            with tracing.span("c"):
                pass
        with tracing.span("b"):
            pass
        with tracing.span("t", hot=True):
            pass
    with tracing.span("frontend/x", root=True):
        with tracing.span("y"):
            with tracing.span("t", hot=True):
                pass
    table = tracing.publish()
    assert set(table) == {"a", "a/b", "a/b/c", "a/t", "frontend/x", "frontend/x/y", "frontend/t"}
    assert table["a"] >= table["a/b"] >= table["a/b/c"]

    core, witness = chip_smoke.golden_system("cpu")   # the front end's spans
    csp.prove(core, witness, device="cpu")
    times = csp.last_phase_times
    assert {k for k in times if "/" not in k} == PHASES
    assert {"frontend/compile", "frontend/witness", "frontend/to_device"} <= set(times)
    assert {"zerocheck/stage1", "zerocheck/stage2", "zerocheck/stage3", "evalcheck/walk",
            "evalcheck/witness_evals", "evalcheck/sumcheck", "piop/rounds", "piop/queries",
            "ring_switch/host_algebra", "ring_switch/device_evals",
            "zerocheck/stage2/sumcheck.round", "zerocheck/stage2/sumcheck.fold",
            "evalcheck/sumcheck/sumcheck.round", "piop/rounds/sumcheck.round"} <= set(times)
    assert any(k.endswith("/transcript") for k in times)
    for k, v in times.items():
        parent = k.rsplit("/", 1)[0]
        if "/" in k and parent in times and not k.endswith("/transcript"):
            assert v <= times[parent] + 1e-6, k
    from binius_tpu_torch.protocols.sumcheck import univariate_zerocheck as uzc
    assert set(uzc.last_stage_times) == {"stage1", "stage2", "stage3"}
    for i in (1, 2, 3):
        assert uzc.last_stage_times[f"stage{i}"] == times[f"zerocheck/stage{i}"]

    csp.verify(core, csp.prove(core, witness, device="cpu"), device="cpu")
    csp.prove(core, witness, device="cpu")   # the verifier left nothing in this table
    assert {k for k in csp.last_phase_times if "/" not in k} == PHASES
    assert not any(k.startswith("frontend/") for k in csp.last_phase_times)


def test_ranges_only_under_profiler(monkeypatch, tmp_path):
    """A proof opens no `record_function` range without a profiler; under
    one every range the prover opens is named with a prefix the benchmark's
    device trace labels idle gaps by."""
    core, witness = chip_smoke.golden_system("cpu")
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    csp.prove(core, witness, device="cpu")
    assert opened == []
    events = _profiled(lambda: (chip_smoke.golden_system("cpu"),
                                csp.prove(core, witness, device="cpu")),
                       tmp_path / "profile.json")
    names = {e["name"] for e in events}
    assert names == set(opened)
    assert {"prove.commit", "zerocheck.stage2", "prove.evalcheck/walk",
            "zerocheck.stage2/sumcheck.round", "prove.piop/rounds/sumcheck.fold",
            "frontend/compile", "frontend/to_device"} <= names
    assert all(n.startswith(device_trace.HOST_RANGE_PREFIXES) for n in names), names
    assert not any(n.endswith("/transcript") for n in names)


def test_stage_ranges_outside_prove(tmp_path):
    """The zerocheck run alone, outside `prove` (as `chip_smoke.stage2_regimes`
    profiles it), still opens its stage ranges, and no range below them;
    it records nothing in the next proof's table."""
    from binius_tpu_torch.protocols.sumcheck import univariate_zerocheck as uzc
    from binius_tpu_torch.transcript.transcript import ProverTranscript

    core, witness = chip_smoke.golden_system("cpu")
    tracing.publish()
    sets, claims = csp._zerocheck_claims(core, ascending=True)
    mls = [[witness[oid] for oid in st.oracle_ids] for st in sets]
    events = _profiled(lambda: uzc.batch_prove(claims, mls, ProverTranscript(),
                                               csp._zerocheck_skip(core)),
                       tmp_path / "profile.json")
    assert {e["name"] for e in events} == {"zerocheck.stage1", "zerocheck.stage2",
                                           "zerocheck.stage3"}
    assert set(uzc.last_stage_times) == {"stage1", "stage2", "stage3"}
    assert tracing.publish() == {}


def test_failed_proof_leaves_next_table_clean(monkeypatch):
    """A proof that raises publishes nothing, and leaves neither its spans
    (its front end's among them) nor its counts in the next proof's table."""
    core, witness = chip_smoke.golden_system("cpu")
    csp.prove(core, witness, device="cpu")
    clean = dict(csp.last_phase_times)
    core, witness = chip_smoke.golden_system("cpu")   # this front end's spans are thrown away
    real = csp.evalcheck.prove

    def failing(*args, **kwargs):
        with tracing.span("marker"):
            tracing.count("readbacks")
        raise RuntimeError("injected")

    monkeypatch.setattr(csp.evalcheck, "prove", failing)
    before = tracing.counters()
    with pytest.raises(RuntimeError, match="injected"):
        csp.prove(core, witness, device="cpu")
    assert tracing.counters() == before
    assert csp.last_phase_times == clean
    monkeypatch.setattr(csp.evalcheck, "prove", real)
    csp.prove(core, witness, device="cpu")
    assert set(csp.last_phase_times) == {k for k in clean if not k.startswith("frontend/")}
    after = tracing.counters()
    clean_proof = csp.prove(core, witness, device="cpu")
    assert clean_proof
    again = tracing.counters()
    assert after["readbacks"] - before["readbacks"] == again["readbacks"] - after["readbacks"]


def test_file_on_profiler_clock(traced):
    """A span's `ts` in the Chrome file is within 1 ms of its profiler
    range's `ts` + baseTimeNanoseconds / 1000, in the same session, once
    the profiler's own offset from the wall clock is taken out: the
    profiler maps its cycle counter to wall-clock time once per session,
    and on a loaded host that map can be off by a millisecond. The offset
    is a bare range's, stamped with `time.time_ns()` beside it. A file on
    another clock (`perf_counter`) is off by years."""
    tr, out = traced
    stamps = {}

    def work():
        stamps["bare"] = time.time_ns() / 1e3
        with torch.profiler.record_function("bare"):
            pass
        with tr.span("phase", range="prove.clock", root=True):
            with tr.span("inner"):
                sum(range(20000))

    events = {e["name"]: e for e in _profiled(work, out.parent / "profile.json")}
    tr.save(str(out))
    mine = {e["name"]: e for e in json.loads(out.read_text())["traceEvents"]}

    def on_wall_clock(e):
        return e["ts"] + e["base_ns"] / 1e3

    offset = stamps["bare"] - on_wall_clock(events["bare"])
    assert abs(offset) < 20e3
    for name in ("prove.clock", "prove.clock/inner"):
        assert abs(mine[name]["ts"] - on_wall_clock(events[name]) - offset) < 1e3
        assert abs(mine[name]["dur"] - events[name]["dur"]) < 1e3


def test_readbacks_per_proof():
    """The "readbacks" counter: more than none per proof, the same on two
    proofs of the golden system, and the sum of its per-phase counts."""
    core, witness = chip_smoke.golden_system("cpu")
    per_proof = []
    for _ in range(2):
        before = tracing.counters()
        csp.prove(core, witness, device="cpu")
        after = tracing.counters()
        assert after["proofs"] == before["proofs"] + 1
        per_proof.append({k: after[k] - before.get(k, 0) for k in after if k != "proofs"})
    assert per_proof[0] == per_proof[1]
    got = per_proof[0]
    assert got["readbacks"] > 0
    phased = {k: v for k, v in got.items() if k.endswith("/readbacks")}
    assert sum(phased.values()) == got["readbacks"]
    assert {k.split("/")[0] for k in phased if phased[k]} <= PHASES


def test_golden_phase_sizes_and_trace(traced):
    tr, out = traced
    core, witness = chip_smoke.golden_system("cpu")
    proof = csp.prove(core, witness, device="cpu")
    assert len(proof) == 7328
    assert csp.last_phase_sizes == chip_smoke.GOLDEN_PHASE_SIZES_8
    assert sum(csp.last_phase_sizes.values()) == 7328
    tr.save(str(out))
    spans = [e for e in json.loads(out.read_text())["traceEvents"]
             if e["ph"] == "X" and e["name"].startswith("prove.") and "/" not in e["name"]]
    phases = [k for k in csp.last_phase_times if k != "total" and "/" not in k]
    assert {e["name"] for e in spans} == {f"prove.{k}" for k in phases}
    for k in phases:
        dur = sum(e["dur"] for e in spans if e["name"] == f"prove.{k}")
        assert abs(dur - csp.last_phase_times[k] * 1e6) < 1.0

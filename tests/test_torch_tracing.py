"""The port's span tracing (`utils/tracing.py`) and the prover's bytes per
phase on the CPU.

`tests/test_tracing.py` is mirrored (Chrome trace-event export of spans,
markers and recorded spans under BINIUS_TRACE_FILE); the golden 8-row
u32_add proof's `last_phase_sizes` equal the JAX package's (pinned in
`chip_smoke.GOLDEN_PHASE_SIZES_8` from `scripts/port_golden_proof.py
--circuit golden_8`) and sum to its 7,328 bytes, and with tracing on the
proof's trace holds one complete span per phase, of the phase's time."""

import atexit
import importlib
import json

import pytest
import torch

import chip_smoke
from binius_tpu_torch.constraint_system import prove as csp
from binius_tpu_torch.utils import tracing

torch.set_num_threads(1)  # the suite's test processes share the cores


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


def test_span_export(traced):
    tr, out = traced
    assert tr.enabled()
    with tr.span("outer"):
        with tr.span("inner", category="kernel"):
            pass
    tr.instant("marker")
    tr.record("legacy", 0.0, 0.5)
    tr.save(str(out))
    data = json.loads(out.read_text())
    names = [e["name"] for e in data["traceEvents"]]
    assert names == ["inner", "outer", "marker", "legacy"]
    kinds = {e["name"]: e["ph"] for e in data["traceEvents"]}
    assert kinds == {"inner": "X", "outer": "X", "marker": "i", "legacy": "X"}
    assert data["traceEvents"][3]["dur"] == 0.5e6
    assert data["displayTimeUnit"] == "ms"


def test_disabled_spans_record_nothing(monkeypatch):
    monkeypatch.delenv("BINIUS_TRACE_FILE", raising=False)
    monkeypatch.delenv("BINIUS_TRACE_PHASES", raising=False)
    tr = importlib.reload(tracing)
    assert not tr.enabled()
    with tr.span("nothing"):
        pass
    tr.instant("nothing")
    tr.record("nothing", 0.0, 1.0)
    assert tr._events == []


def test_golden_phase_sizes_and_trace(traced):
    tr, out = traced
    core, witness = chip_smoke.golden_system("cpu")
    proof = csp.prove(core, witness, device="cpu")
    assert len(proof) == 7328
    assert csp.last_phase_sizes == chip_smoke.GOLDEN_PHASE_SIZES_8
    assert sum(csp.last_phase_sizes.values()) == 7328
    tr.save(str(out))
    spans = [e for e in json.loads(out.read_text())["traceEvents"]
             if e["ph"] == "X" and e["name"].startswith("prove.")]
    phases = [k for k in csp.last_phase_times if k != "total"]
    assert {e["name"] for e in spans} == {f"prove.{k}" for k in phases}
    for k in phases:
        dur = sum(e["dur"] for e in spans if e["name"] == f"prove.{k}")
        assert abs(dur - csp.last_phase_times[k] * 1e6) < 1.0

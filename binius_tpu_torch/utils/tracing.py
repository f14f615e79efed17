"""Span tracing, exported as Chrome trace-event JSON.

The port of `binius_tpu/utils/tracing.py`: nested host spans, zero-length
markers and spans measured elsewhere (the prover's phase timer records
each phase), written as a Chrome trace-event file that Perfetto and
chrome://tracing load. Two variables, read when the module is imported:

- ``BINIUS_TRACE_PHASES=1``: print each span's time as it closes (and
  each proof phase's time and proof bytes, `constraint_system.prove`);
- ``BINIUS_TRACE_FILE=trace.json``: collect the spans and write the trace
  there when the process exits.

With neither set a span costs one check. Device time is not in these
spans but where a phase ends in a CUDA synchronize; `torch.profiler`
sees the device, and the prover's phases as its `record_function`
ranges.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time

_PRINT = os.environ.get("BINIUS_TRACE_PHASES", "") not in ("", "0")
_FILE = os.environ.get("BINIUS_TRACE_FILE", "")
_events: list = []
_tls = threading.local()


def enabled() -> bool:
    return _PRINT or bool(_FILE)


def _depth() -> int:
    return getattr(_tls, "depth", 0)


def _event(name: str, category: str, ph: str, ts: float, **kw) -> dict:
    return {"name": name, "cat": category, "ph": ph, "ts": ts * 1e6, **kw,
            "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFF}


@contextlib.contextmanager
def span(name: str, category: str = "phase"):
    """A nested timed span: ``with tracing.span("commit"): ...``."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    _tls.depth = _depth() + 1
    try:
        yield
    finally:
        t1 = time.perf_counter()
        _tls.depth = _depth() - 1
        if _FILE:
            _events.append(_event(name, category, "X", t0, dur=(t1 - t0) * 1e6))
        if _PRINT:
            print(f"{'  ' * _depth()}[{category}] {name}: {(t1 - t0) * 1e3:.1f} ms", flush=True)


def instant(name: str, category: str = "mark") -> None:
    """A zero-length marker."""
    if _FILE:
        _events.append(_event(name, category, "i", time.perf_counter(), s="t"))


def record(name: str, t0: float, dur: float, category: str = "phase") -> None:
    """A span measured elsewhere: its `time.perf_counter()` start and its
    length in seconds."""
    if _FILE:
        _events.append(_event(name, category, "X", t0, dur=dur * 1e6))


def save(path: str) -> None:
    """Write the collected events as a Chrome trace-event file."""
    with open(path, "w") as f:
        json.dump({"traceEvents": _events, "displayTimeUnit": "ms"}, f)


if _FILE:
    atexit.register(save, _FILE)

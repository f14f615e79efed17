"""Spans and counters of the prover, on the profiler's clock.

The port of `binius_tpu/utils/tracing.py`, and the port's one span
mechanism: ``with tracing.span(name): ...`` times a stretch of host work.

- Its wall seconds accumulate into a table keyed by its path, the names of
  the open spans joined by "/" ("evalcheck/walk"). `publish()` hands the
  table over and starts a new one: `constraint_system.prove.prove`
  publishes it as `last_phase_times` when the proof ends, so the spans
  closed before the proof (its front end's) are in that proof's table.
- While a torch.profiler runs, it is a `record_function` range, named by
  its own `range` ("prove.commit", "zerocheck.stage1") or by its parent's
  range and its name ("prove.evalcheck/walk"), so that the device trace
  puts each idle gap of the card down to the innermost span open.
- ``BINIUS_TRACE_PHASES=1`` prints it as it closes;
  ``BINIUS_TRACE_FILE=trace.json`` writes it as a Chrome trace event when
  the process exits (Perfetto, chrome://tracing), stamped on the
  profiler's clock, wall-clock microseconds, so that the file and a device
  trace of the same run overlay. Both are read when the module is imported.

A span opened while no span is open is recorded only if it is a `root`
(the prover's phases, the front end's steps); any other span then times
itself alone (`seconds`), so that a protocol run outside a proof (a
verifier, a test) leaves nothing in the next proof's table, and is a
profiler range only if it names its `range` (a zerocheck stage). `discard()`
throws away what a proof that failed recorded. A `hot` span,
entered many times per proof (the transcript's hashing), only accumulates,
under its phase ("zerocheck/transcript"): no range, no print, no event.
With no profiler, no print and no file a span costs two clock reads and a
dictionary add.

`count(name)` adds one to an integer counter inside a recorded span, and
to "<phase>/<name>"; `counters()` holds the sums over every proof of the
process that `publish` closed, with their number under "proofs" (counts
per proof are fixed by a system's shapes, so a reader takes the mean).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time

import torch

_PRINT = os.environ.get("BINIUS_TRACE_PHASES", "") not in ("", "0")
_FILE = os.environ.get("BINIUS_TRACE_FILE", "")
_events: list = []
_open: list = []            # the open spans, innermost last
_table: dict = {}           # path -> seconds, since the last publish
_counts: dict = {}          # counter -> count, since the last publish
_counters: dict = {"proofs": 0}
_profiling = torch.autograd._profiler_enabled


def enabled() -> bool:
    """Whether spans are printed or written to a file."""
    return _PRINT or bool(_FILE)


class span:
    """``with span(name, range=None, root=False, hot=False): ...``; the
    module's docstring says what it records. `seconds` holds its time once
    it has closed."""

    __slots__ = ("name", "range", "root", "hot", "key", "phase", "seconds", "_t0", "_wall",
                 "_rf")

    def __init__(self, name: str, range: str | None = None, root: bool = False,
                 hot: bool = False):
        self.name, self.range, self.root, self.hot = name, range, root, hot
        self.seconds = 0.0

    def __enter__(self) -> "span":
        parent = _open[-1] if _open else None
        if parent is not None and parent.key is not None:
            self.phase = parent.phase
            self.key = f"{parent.phase if self.hot else parent.key}/{self.name}"
            if self.range is None:
                self.range = f"{parent.range}/{self.name}"
        elif self.root:
            self.phase = self.name.split("/", 1)[0]
            self.key = self.name
            if self.range is None:
                self.range = self.name
        else:
            self.key = None
        self._rf = None
        if not self.hot:
            _open.append(self)
            if self.range is not None and _profiling():
                self._rf = torch.profiler.record_function(self.range)
                self._rf.__enter__()
            if self.key is not None and _FILE:
                self._wall = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = dt = time.perf_counter() - self._t0
        key = self.key
        if key is not None:
            _table[key] = _table.get(key, 0.0) + dt
        if self.hot:
            return
        _open.pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        if key is None:
            return
        if _FILE:
            _events.append({"name": self.range, "cat": "span", "ph": "X",
                            "ts": self._wall / 1e3, "dur": dt * 1e6, "pid": os.getpid(),
                            "tid": threading.get_ident() & 0xFFFF})
        if _PRINT:
            print(f"{'  ' * len(_open)}{self.range}: {dt * 1e3:.1f} ms", flush=True)


def count(name: str) -> None:
    """One more `name` (and "<phase>/<name>") inside a recorded span."""
    if _open and _open[-1].key is not None:
        phased = f"{_open[-1].phase}/{name}"
        _counts[name] = _counts.get(name, 0) + 1
        _counts[phased] = _counts.get(phased, 0) + 1


def counters() -> dict:
    """The counters summed over every published proof of the process, and
    "proofs"."""
    return dict(_counters)


def publish() -> dict:
    """The table of the spans closed since the last publish; its counts go
    into `counters()`, a new table starts, and one more proof is counted."""
    global _table
    out, _table = _table, {}
    for name, n in _counts.items():
        _counters[name] = _counters.get(name, 0) + n
    _counts.clear()
    _counters["proofs"] += 1
    return out


def discard() -> None:
    """Throw away the spans and counts recorded since the last publish (a
    proof that failed, and its front end's)."""
    _table.clear()
    _counts.clear()


def save(path: str) -> None:
    """Write the collected events as a Chrome trace-event file."""
    with open(path, "w") as f:
        json.dump({"traceEvents": _events, "displayTimeUnit": "ms"}, f)


if _FILE:
    atexit.register(save, _FILE)

"""Structured tracing and metrics.

The port's copy of ``cnf2freq_tpu/utils/tracing.py`` (no JAX, no import
of the JAX package).

The reference has no observability beyond ad-hoc stderr printf lines
(progress at cnF2freq.cpp:5399-5402, 5908; "Scale factor now" at
cnF2freq.cpp:6392) — SURVEY.md §5 calls this out as a gap the rebuild
must fill.  This module provides:

* ``Tracer`` — hierarchical wall-clock spans (``with tracer.span("fb")``)
  with per-span call counts and cumulative time, cheap enough to stay on
  in production.
* structured per-iteration metric records (``Tracer.metric``) that the
  driver emits (hitnnn, inversions, scalefactor, likelihood sums), kept
  in memory and optionally streamed as JSON lines to a file — a greppable
  replacement for the reference's racy stdout ("This output can get ugly
  due to race conditions", cnF2freq.cpp:5398).

Device-side profiling stays with ``torch.profiler`` (and
``profile_slice``); these spans read the host clock and add no
synchronisation, so a span around a device stage measures what the host
spent there, enqueueing or waiting (where the reference's OpenMP
scheduling lived).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO


@dataclass
class SpanStat:
    calls: int = 0
    total_s: float = 0.0


@dataclass
class Tracer:
    """Process-local tracer; attach one to a Driver via ``driver.tracer``."""

    sink: Optional[TextIO] = None       # JSONL stream, one record per line
    enabled: bool = True
    spans: Dict[str, SpanStat] = field(default_factory=dict)
    metrics: List[dict] = field(default_factory=list)
    _stack: List[str] = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            st = self.spans.setdefault(path, SpanStat())
            st.calls += 1
            st.total_s += dt
            self._emit({"type": "span", "name": path, "seconds": dt})

    def metric(self, **kv):
        """Record one structured metric event (e.g. per-iteration stats)."""
        if not self.enabled:
            return
        rec = {"type": "metric", "t": time.time(), **kv}
        self.metrics.append(rec)
        self._emit(rec)

    def _emit(self, rec: dict):
        if self.sink is not None:
            self.sink.write(json.dumps(rec) + "\n")
            self.sink.flush()

    def report(self) -> str:
        """Human-readable span summary, longest cumulative time first."""
        lines = ["span                                calls    total_s"]
        for name, st in sorted(self.spans.items(),
                               key=lambda kv: -kv[1].total_s):
            lines.append(f"{name:<36}{st.calls:>6}{st.total_s:>11.3f}")
        return "\n".join(lines)


class NullTracer(Tracer):
    """Tracer with everything compiled out (enabled=False default)."""

    def __init__(self):
        super().__init__(enabled=False)

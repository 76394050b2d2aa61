"""The port's copy of ``utils/tracing.py`` and the spans of its Driver (no
JAX: the iteration records are held to the JAX Driver's in
tests/test_torch_resident_parity.py and tests/test_torch_formats_cli.py).

* tests/test_tracing.py's two unit tests on the port's ``Tracer`` and
  ``NullTracer``.
* The Driver's span paths on each iteration form, 3 x 8 cohorts in
  float64 on the CPU, early plus one full iteration: the resident
  iteration, the host-gathered one, a marker-blocked chromosome (block 4)
  and parity mode each enter the spans of their stages, and write one
  ``iteration`` record an iteration.
"""

import io
import json

import pytest
import torch
import torch_port_util  # noqa: F401  (one torch thread a worker)

from cnf2freq_tpu_torch import Driver
from cnf2freq_tpu_torch.utils.simulate import simulate_f2
from cnf2freq_tpu_torch.utils.tracing import NullTracer, Tracer


def test_spans_and_metrics():
    sink = io.StringIO()
    tr = Tracer(sink=sink)
    with tr.span("outer"):
        with tr.span("inner"):
            pass
        with tr.span("inner"):
            pass
    tr.metric(event="iteration", hitnnn=3)
    assert tr.spans["outer"].calls == 1
    assert tr.spans["outer/inner"].calls == 2
    assert tr.spans["outer"].total_s >= tr.spans["outer/inner"].total_s
    recs = [json.loads(line) for line in sink.getvalue().splitlines()]
    kinds = {r["type"] for r in recs}
    assert kinds == {"span", "metric"}
    m = [r for r in recs if r["type"] == "metric"][0]
    assert m["hitnnn"] == 3 and "t" in m
    rep = tr.report()
    assert "outer/inner" in rep


def test_null_tracer_is_noop():
    tr = NullTracer()
    with tr.span("x"):
        pass
    tr.metric(a=1)
    assert not tr.spans and not tr.metrics


PREPROCESS = {"preprocess", "preprocess/correction_inference",
              "preprocess/variances", "preprocess/lockhaplos"}
SPANS = {
    "resident": {"gather", "scan", "scatter", "coherence", "flips",
                 "flips/optimise", "flips/optimise/score",
                 "flips/optimise/solve", "flips/optimise/filter", "updates",
                 "updates/stack", "updates/device", "updates/writeback"},
    "host": {"gather", "scan", "scatter", "coherence", "flips",
             "flips/optimise", "flips/optimise/score", "updates",
             "updates/infprobs", "updates/infprobs/stack",
             "updates/infprobs/device", "updates/haploweights"},
    "blocked": {"carries", "block", "scatter", "score", "flips",
                "flips/solve", "flips/filter", "updates",
                "updates/infprobs", "updates/haploweights"},
    "parity": {"gather", "scan", "scatter", "flips", "updates",
               "updates/infprobs", "updates/haploweights"},
}


@pytest.mark.parametrize("form", list(SPANS))
def test_driver_spans(form):
    d = Driver(simulate_f2(n_f2=3, n_markers=8, seed=2), dtype=torch.float64,
               device="cpu", parity=form == "parity")
    d.resident = {"resident": True, "host": False}.get(form)
    if form == "blocked":
        d.marker_block = 4
    d.tracer = Tracer()
    d.preprocess()
    d.iterate(early=True)
    d.iterate()
    spans = set(d.tracer.spans)
    assert PREPROCESS | SPANS[form] <= spans
    if form != "resident":
        assert not {"updates/writeback", "updates/stack"} & spans
    if form != "blocked":
        assert not {"carries", "block"} & spans
    its = [m for m in d.tracer.metrics if m.get("event") == "iteration"]
    assert [m["iter"] for m in its] == [1, 2]
    assert all(isinstance(m["flips"], int) for m in its)

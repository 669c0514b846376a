"""Giving device time to the program's spans (``bench/spans.py``).

* the arithmetic on a hand-made trace: each kernel to the innermost span
  open at its launch, overlapping streams counted once, idle gaps by
  their middle, kernels with no launch and launches outside every span;
* on a trace recorded on a card (``record_span_fixture.py``): every
  kernel joins its launch; every launch lands in the span that was open
  when it was issued, by the marker kernels' correlation ids (no clock),
  with none misattributed; the backward's launches from autograd's thread
  land in ``step.backward``; the parts of ``by_span`` sum to ``busy_us``;
* ``phases.measure`` on a tiny cell on the CPU, end to end.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench import spans, trace

FIXTURE = Path(__file__).with_name("fixtures") / "flat_steps.spans.json"
BASE = 1_700_000_000_000_000_000
MARKER = "spin_kernel"


def _span(name, a_us, b_us, step=0):
    return {"name": name, "start_ns": BASE + int(a_us * 1000),
            "end_ns": BASE + int(b_us * 1000), "step": step}


def _launch(c, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 3.0, "tid": tid, "args": {"correlation": c}}


def _kernel(c, a, b, stream=7):
    return {"ph": "X", "cat": "kernel", "name": f"k{c}", "ts": a, "dur": b - a,
            "tid": stream, "args": {"correlation": c, "stream": stream}}


def test_attribution_by_hand():
    program = [_span("trainer.step", 0, 1000), _span("step.forward", 100, 380),
               _span("step.backward", 420, 800), _span("trainer.flush", 1400, 1500, None)]
    events = [_launch(1, 150), _kernel(1, 200, 300),
              _launch(2, 450, tid=2), _kernel(2, 500, 700),
              _launch(3, 460, tid=2), _kernel(3, 600, 750),
              _launch(4, 350), _kernel(4, 650, 760, stream=9),   # a side stream
              _launch(5, 900), _kernel(5, 950, 1000),
              _launch(6, 1200), _kernel(6, 1250, 1300),
              _kernel(99, 1300, 1310)]                           # no launch kept
    att = spans.attribute(events, program, BASE, steps=1)
    cap = trace.from_events(events, None, 1)
    assert att.window == cap.span == (150.0, 1310.0)
    assert att.busy == pytest.approx({"step.forward": 110.0, "step.backward": 250.0,
                                      "trainer.step": 50.0, spans.OUTSIDE: 50.0,
                                      spans.UNJOINED: 10.0})
    assert att.busy_us == pytest.approx(trace.busy_us(cap))
    # gaps: [150, 200] in the forward; [300, 500] and [760, 950] between
    # the step's children; [1000, 1250] after the step
    assert att.idle == pytest.approx({"step.forward": 50.0, "trainer.step": 390.0,
                                      spans.OUTSIDE: 250.0})
    assert sum(att.idle.values()) == pytest.approx(cap.window_us - trace.busy_us(cap))
    rows = {r[0]: r[1:] for r in att.by_span()}
    assert rows["step.backward"] == pytest.approx([250e-6, 0.0])
    assert att.phase_ms("step.forward") == pytest.approx(0.11)
    assert att.phase_ms("step.sync") is None
    assert att.largest_gaps(1) == [[spans.OUTSIDE, 850.0, pytest.approx(250e-6)]]
    assert att.gaps_by_span() == [
        ["trainer.step", 2, pytest.approx(390e-6), pytest.approx(200e-6)],
        [spans.OUTSIDE, 1, pytest.approx(250e-6), pytest.approx(250e-6)],
        ["step.forward", 1, pytest.approx(50e-6), pytest.approx(50e-6)]]
    before = {r[0]: r[1:] for r in att.gaps_before()}
    assert before["k6"] == [pytest.approx(250e-6), 1, {spans.OUTSIDE: pytest.approx(250e-6)}]
    assert before["k5"] == [pytest.approx(190e-6), 1, {"trainer.step": pytest.approx(190e-6)}]
    assert before["k2"] == [pytest.approx(200e-6), 1, {"trainer.step": pytest.approx(200e-6)}]
    top = {r[0]: r[2] for r in att.top_ops()}
    assert top["k4"] == {"step.forward": pytest.approx(110e-6)}
    assert spans.issue_ms(program) == pytest.approx(1.0)


@pytest.fixture(scope="module")
def recorded():
    with open(FIXTURE) as f:
        fx = json.load(f)
    att = spans.attribute(fx["traceEvents"], fx["spans"], fx["baseTimeNanoseconds"],
                          fx["steps"])
    return fx, att


def _truth_by_markers(fx):
    """(correlation of each launch, the name of the span open when it was
    issued): the spans' open and close events in program order, matched one
    for one to the marker launches in correlation order."""
    sp = fx["spans"]
    kids: dict = {}
    for i, s in enumerate(sp):
        kids.setdefault(s["parent"], []).append(i)
    order: list[tuple[str, int]] = []

    def walk(i):
        order.append(("open", i))
        for j in kids.get(i, []):
            walk(j)
        order.append(("close", i))
    for i in kids.get(None, []):
        walk(i)
    ev = fx["traceEvents"]
    kernel_of = {e["args"]["correlation"]: e["name"] for e in ev if e["cat"] == "kernel"}
    launches = sorted((e for e in ev if e["name"] in trace.LAUNCH_CALLS),
                      key=lambda e: e["args"]["correlation"])
    markers = [e for e in launches if MARKER in kernel_of.get(e["args"]["correlation"], "")]
    assert len(markers) == len(order) == 2 * len(sp)
    cuts = [m["args"]["correlation"] for m in markers]
    truth = []
    for e in launches:
        c = e["args"]["correlation"]
        k = sum(1 for x in cuts if x <= c) - 1
        if k < 0:
            name = spans.OUTSIDE
        else:
            what, i = order[k]
            if what == "open" or c == cuts[k]:
                name = sp[i]["name"]
            else:
                p = sp[i]["parent"]
                name = sp[p]["name"] if p is not None else spans.OUTSIDE
        truth.append((e, name))
    return truth, markers


def test_recorded_kernels_join_their_launches(recorded):
    fx, att = recorded
    calls = {e["args"]["correlation"] for e in fx["traceEvents"]
             if e["cat"] in ("cuda_runtime", "cuda_driver")}
    kernels = [e for e in fx["traceEvents"] if e["cat"] == "kernel"]
    assert len(kernels) > 100
    assert all(e["args"]["correlation"] in calls for e in kernels)
    assert spans.UNJOINED not in att.busy


def test_recorded_launches_land_in_the_span_that_issued_them(recorded):
    fx, att = recorded
    truth, _ = _truth_by_markers(fx)
    wrong = [(e["args"]["correlation"], want, att.inner.at(e["ts"]))
             for e, want in truth if att.inner.at(e["ts"]) != want]
    assert len(truth) > 100 and wrong == []


def test_recorded_backward_launches_from_autograds_thread(recorded):
    fx, att = recorded
    truth, markers = _truth_by_markers(fx)
    main = {m["tid"] for m in markers}
    assert len(main) == 1
    other = [e for e, _ in truth if e["tid"] not in main]
    assert len(other) > 20
    assert {att.inner.at(e["ts"]) for e in other} == {"step.backward"}


def test_recorded_by_span_sums_to_busy(recorded):
    fx, att = recorded
    cap = trace.from_events(fx["traceEvents"], None, fx["steps"])
    assert sum(r[1] for r in att.by_span()) * 1e6 == pytest.approx(trace.busy_us(cap))
    assert sum(r[2] for r in att.by_span()) * 1e6 == pytest.approx(
        cap.window_us - trace.busy_us(cap))
    for name in ("step.forward", "step.backward", "step.sync", "step.optimizer"):
        assert att.phase_ms(name) > 0
    assert spans.issue_ms(fx["spans"]) > 0


def test_phases_on_a_tiny_cell_on_the_cpu(tiny_root):
    from bench import phases
    out = phases.measure("tiny-gpt2.flat.none", 2 ** 31 + 11, 0.2, device="cpu",
                         root=tiny_root)
    assert out["tokens_per_s_off"] > 0 and out["tokens_per_s_on"] > 0
    on = out["traced_on"]
    names = [n for n, _, _ in on["spans"]]
    assert names.count("trainer.step") == 3 and names.count("step.sync") == 3
    assert on["host.issue_ms"] > 0
    assert "by_span" not in out["traced_off"]
    assert out["window_order"] == ("off", "on", "on", "off")
    assert 0 < out["span_us"]["off"] < out["span_us"]["on"]

"""The port's program spans (``repro_torch.obs.trace``): the recorder's
nesting, parents and step ids; that off it records, keeps and launches
nothing; the spans of the flat ``Trainer.run`` in their order; bit-equal
training with spans on and off; the spans on a ``torch.profiler`` trace's
clock; and ``profiler_session`` merging them into its trace.
"""
import json
import threading
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import EDGCConfig, GDSConfig
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.obs import trace
from repro_torch.obs.trace import (profiler_session, record_spans, span,
                                   span_events, validate_trace)
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

MODEL = dict(name="spans", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
             max_position=16, num_stages=1)
DATA = dict(vocab_size=128, seq_len=8, batch_size=2, seed=5)
#: the spans of one flat step, in order of entry, and those of some steps
STEP_SPANS = ("trainer.step", "trainer.batch", "step.forward",
              "step.backward", "step.sync", "step.entropy", "step.optimizer",
              "trainer.flush", "trainer.replan")


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _trainer(steps, *, window=4, log_every=3, policy="fixed"):
    edgc = EDGCConfig(policy=policy, fixed_rank=4, num_stages=1,
                      total_iterations=steps,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=window, adjust_limit=4))
    tcfg = TrainerConfig(total_steps=steps, log_every=log_every,
                         adam=AdamConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=steps))
    return Trainer(build_model(ModelConfig(**MODEL)), edgc, tcfg, seed=0,
                   device="cpu")


# ------------------------------------------------------------- recorder
def test_nesting_parents_and_step_ids():
    with record_spans() as spans:
        with span("outer", step=7, gated=True) as a:
            with span("inner"):
                with span("leaf", n=3):
                    pass
            with span("sibling", step=8):
                pass
        with span("top"):
            pass
    assert a is spans[0]
    assert [s.name for s in spans] == ["outer", "inner", "leaf", "sibling", "top"]
    assert [s.parent for s in spans] == [None, 0, 1, 0, None]
    assert [s.step for s in spans] == [7, 7, 7, 8, None]
    assert spans[0].args == {"gated": True} and spans[2].args == {"n": 3}
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def _in_worker():
    with span("worker"):
        pass


def test_threads_nest_apart_and_args_hold_no_tensor():
    with record_spans() as spans:
        with span("main", step=1):
            t = threading.Thread(target=_in_worker)
            t.start()
            t.join()
        with pytest.raises(TypeError, match="numbers and strings"):
            with span("bad", value=torch.ones(1)):
                pass
        with pytest.raises(RuntimeError, match="already recording"):
            with record_spans():
                pass
    worker = next(s for s in spans if s.name == "worker")
    assert worker.parent is None and worker.step is None
    assert not any(s.name == "bad" for s in spans)


def test_off_is_one_shared_object_and_records_nothing():
    assert span("a") is span("b", step=3, gated=True)
    with span("a") as got:
        assert got is None
    with record_spans() as spans:
        pass
    assert spans == [] and trace._REC is None and not trace._ON


def test_span_events_on_a_trace_clock():
    with record_spans() as spans:
        with span("trainer.step", step=4, gated=False):
            with span("step.sync"):
                pass
    base = spans[0].start_ns - 2_000_000
    events = span_events(spans, base, pid=11, tid=0)
    summary = validate_trace({"traceEvents": events})
    assert summary["spans"] == 2 and summary["by_cat"] == {"program": 2}
    meta, outer, inner = events
    assert meta["ph"] == "M" and meta["args"]["name"] == "program spans"
    assert outer["ts"] == pytest.approx(2000.0)
    assert outer["dur"] == pytest.approx((spans[0].end_ns - spans[0].start_ns) / 1e3)
    assert outer["args"] == {"step": 4, "gated": False}
    assert inner["args"] == {"step": 4, "parent": "trainer.step"}
    assert (outer["pid"], outer["tid"]) == (11, 0)


# ------------------------------------------------------ the trainer's spans
def test_trainer_steps_give_their_spans_in_order():
    steps = 8
    tr = _trainer(steps)
    data = SyntheticLM(**DATA).batches()
    with record_spans() as spans:
        tr.run(data, num_steps=steps)
    by_step: dict = {}
    for i, s in enumerate(spans):
        by_step.setdefault(s.step, []).append((i, s))
    assert sorted(k for k in by_step if k is not None) == list(range(steps))
    for t in range(steps):
        (i0, top), *rest = by_step[t]
        assert top.name == "trainer.step" and top.parent is None
        gated = tr.controller.wants_entropy(t)
        assert top.args == {"gated": gated}
        flushed = t % 3 == 0 or (t + 1) % 4 == 0 or t == steps - 1
        want = ["trainer.batch", "step.forward", "step.backward", "step.sync"]
        want += ["step.entropy"] * gated + ["step.optimizer"]
        want += ["trainer.flush"] * flushed + ["trainer.replan"] * ((t + 1) % 4 == 0)
        assert [s.name for _, s in rest] == want
        assert all(s.parent == i0 for _, s in rest)
        assert all(top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
                   for _, s in rest)
        starts = [s.start_ns for _, s in rest]
        assert starts == sorted(starts)
    # the run's last flush sits after its last step, outside every step
    assert spans[-1].name == "trainer.flush" and spans[-1].step is None
    assert {s.name for s in spans} <= set(STEP_SPANS)


def test_spans_on_and_off_train_bit_equal():
    steps = 6
    out = []
    for on in (False, True):
        tr = _trainer(steps, log_every=1)
        data = SyntheticLM(**DATA).batches()
        if on:
            with record_spans() as spans:
                tr.run(data, num_steps=steps)
            assert len(spans) > 6 * steps
        else:
            tr.run(data, num_steps=steps)
        out.append(tr)
    off, on = out
    assert [h["loss"] for h in off.history] == [h["loss"] for h in on.history]
    for key in ("params", "opt_m", "opt_v"):
        for a, b in zip(_leaves(off.state[key]), _leaves(on.state[key])):
            assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def test_off_keeps_nothing_and_calls_no_device_hook(monkeypatch):
    """100 steps with spans off leave no allocation made in the recorder's
    module alive, and neither off nor on does a span make a CUDA event, a
    synchronise or a ``record_function``."""
    def refuse(*a, **k):
        raise AssertionError("a span reached the device or the profiler")
    for mod, name in ((torch.cuda, "Event"), (torch.cuda, "synchronize"),
                      (torch.autograd.profiler, "record_function"),
                      (torch.profiler, "record_function")):
        monkeypatch.setattr(mod, name, refuse)
    steps = 100
    tr = _trainer(steps, window=50, log_every=50)
    data = SyntheticLM(**DATA).batches()
    tr.run(data, num_steps=2)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        tr.run(data, num_steps=steps - 4)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, trace.__file__)]
    grown = after.filter_traces(only).compare_to(before.filter_traces(only), "lineno")
    assert sum(d.size_diff for d in grown) <= 0 and sum(d.count_diff for d in grown) <= 0
    assert trace._REC is None
    with record_spans() as spans:
        tr.run(data, num_steps=2)
    assert len(spans) >= 2 * 7


# ------------------------------------------------------------ the clock
def test_spans_meet_record_function_on_the_profilers_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_spans() as spans:
            for i in range(5):
                with span(f"block{i}"), record_function(f"block{i}"):
                    torch.ones(96, 96) @ torch.ones(96, 96)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    obj = json.loads(path.read_text())
    rf = {e["name"]: e for e in obj["traceEvents"]
          if e.get("ph") == "X" and e["name"].startswith("block")}
    placed = {e["name"]: e for e in span_events(spans, obj["baseTimeNanoseconds"])
              if e["ph"] == "X"}
    assert set(rf) == set(placed) == {f"block{i}" for i in range(5)}
    for name, ev in rf.items():
        sp = placed[name]
        # the span opens before the annotation (whose first entry costs the
        # profiler some hundreds of us) and they close within 100 us of each
        # other on the trace's clock
        assert sp["ts"] <= ev["ts"] + 100
        assert abs((ev["ts"] + ev["dur"]) - (sp["ts"] + sp["dur"])) < 100


def test_profiler_session_merges_the_spans(tmp_path):
    tr = _trainer(4)
    data = SyntheticLM(**DATA).batches()
    tr.run(data, num_steps=1)
    with profiler_session(True, str(tmp_path)):
        tr.run(data, num_steps=2)
    obj = json.loads((tmp_path / "trace.json").read_text())
    assert "baseTimeNanoseconds" in obj
    ours = [e for e in obj["traceEvents"] if e.get("cat") == "program"]
    names = [e["name"] for e in ours]
    assert names.count("trainer.step") == 2 and names.count("step.sync") == 2
    ops = [e for e in obj["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    steps = [e for e in ours if e["name"] == "trainer.step"]
    # the profiler's ops of the steps fall inside the steps' spans
    mm = [e for e in ops if e["name"] in ("aten::mm", "aten::bmm", "aten::addmm")]
    assert mm and all(any(s["ts"] <= e["ts"] <= s["ts"] + s["dur"] for s in steps)
                      for e in mm)

"""The serving engine's ranges on the profiler's clock and its padding
tallies (`repro_torch.core.trace.region`, `Profiler.tally`), on the CPU
at the smoke size: the tallies against counts worked out by hand, the
ranges' nesting under a CPU-only torch.profiler, and no
`record_function` built while nothing would record it."""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import smoke_config
from repro_torch.core import Profiler, Tracer
from repro_torch.core import trace as trace_mod
from repro_torch.serve.engine import ServeEngine

ARCH = "qwen2-0.5b"
KW = dict(max_slots=2, page_size=8, max_seq=32, prompt_bucket=16)
LENS = (5, 9, 3)
MAX_NEW = 4


def _run(profile=None):
    cfg = smoke_config(ARCH, dtype=torch.float32)
    eng = ServeEngine(cfg, device="cpu", profile=profile, **KW)
    rng = np.random.default_rng(3)
    for n in LENS:
        eng.submit(rng.integers(1, 100, size=n), MAX_NEW)
    return eng, eng.run()


@pytest.mark.parametrize("kind", [Profiler, Tracer])
def test_engine_tallies_the_padding(kind):
    """Two slots: requests 0 and 1 prefill in the first step and decode
    together for 3 steps, then request 2 prefills and decodes alone for
    3: 6 decode steps.  A request of prompt p decodes its tokens 2..4 at
    positions p, p + 1 and p + 2, over contexts of p + 1, p + 2 and
    p + 3 positions, reading the pages up to each position; the idle
    slot of request 2's steps reads its null page."""
    prof = kind()
    eng, out = _run(prof)
    assert all(len(t) == MAX_NEW for t in out.values())
    ps = KW["page_size"]
    live = sum(p + j for p in LENS for j in range(1, MAX_NEW))
    read = sum((p + j) // ps + 1 for p in LENS for j in range(MAX_NEW - 1)) \
        * ps + 3 * ps
    assert prof.tallies() == {
        "serve.prefill.prompt_tokens": sum(LENS),
        "serve.prefill.bucket_tokens": len(LENS) * KW["prompt_bucket"],
        "serve.decode.kv_positions_live": live,
        "serve.decode.kv_positions_read": read}
    assert live == 69
    assert read == 120
    assert not any(k.startswith("serve.decode.kv")
                   for k in prof.counters())


def test_tallies_off_and_reset():
    prof = Profiler(level=0)
    prof.tally("x", 3)
    assert prof.tallies() == {}
    prof.pcontrol(1)
    prof.tally("x", 3)
    prof.tally("x", 2)
    assert prof.tallies() == {"x": 5}
    prof.reset()
    assert prof.tallies() == {}


def _annotations(prof):
    """(start, end, name) of the user ranges a stopped profiler saw."""
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _parents(spans):
    """{name: Counter of the innermost enclosing range's name}."""
    out = collections.defaultdict(collections.Counter)
    for s, e, name in spans:
        holders = [h for h in spans if h[0] <= s and e <= h[1]
                   and h != (s, e, name)]
        inner = min(holders, key=lambda h: h[1] - h[0], default=None)
        out[name][inner[2] if inner else None] += 1
    return out


def test_ranges_nest_under_a_cpu_profiler():
    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng, _ = _run(tracer)
    parents = _parents(_annotations(prof))
    n_layers = eng.cfg.n_layers
    steps, prefills, decodes = 7, len(LENS), 6
    assert parents["serve.step"] == {None: steps}
    for name in ("serve.schedule", "serve.emit"):
        assert set(parents[name]) == {"serve.step"}
    assert parents["serve.prefill"] == {"serve.step": prefills}
    assert parents["serve.decode"] == {"serve.step": decodes}
    assert parents["serve.batch"] == {"serve.step": prefills + decodes,
                                      "serve.prefill": prefills,
                                      "serve.decode": decodes}
    assert parents["serve.sample"] == {"serve.prefill": prefills,
                                       "serve.decode": decodes}
    for name in ("model.embed", "model.layers", "model.head"):
        assert parents[name] == {"serve.prefill": prefills,
                                 "serve.decode": decodes}
    for name in ("layer.attn.qkv", "layer.attn.kv", "layer.attn.core",
                 "layer.attn.out", "layer.mlp"):
        assert parents[name] == {
            "model.layers": n_layers * (prefills + decodes)}
    # the ranges draw nothing in the tracer's own document
    names = {e["name"] for e in tracer.to_chrome()["traceEvents"]}
    assert "serve.decode" in names and "layer.attn.kv" not in names
    assert "model.layers" not in names


def test_span_opens_a_range_only_while_a_profiler_records():
    tracer = Tracer()
    with tracer.span("outer"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("outer"):
            with trace_mod.region(tracer, "inner"):
                torch.ones(2).sum()
        with trace_mod.region(Profiler(), "plain"):
            pass
        tracer.pcontrol(0)
        with trace_mod.region(tracer, "disabled"):
            pass
    parents = _parents(_annotations(prof))
    assert parents["outer"] == {None: 1}
    assert parents["inner"] == {"outer": 1}
    assert "plain" not in parents and "disabled" not in parents


def _refuse(*a, **k):
    raise AssertionError("record_function built with nothing to record")


@pytest.mark.parametrize("case", ["no profile, profiler on",
                                  "tracer, profiler off"])
def test_no_record_function_when_nothing_records(case, monkeypatch):
    if case == "no profile, profiler on":
        with profile(activities=[ProfilerActivity.CPU]):
            monkeypatch.setattr(torch.profiler, "record_function", _refuse)
            monkeypatch.setattr(torch.autograd.profiler, "record_function",
                                _refuse)
            _, out = _run(None)
            monkeypatch.undo()
    else:
        monkeypatch.setattr(torch.profiler, "record_function", _refuse)
        monkeypatch.setattr(torch.autograd.profiler, "record_function",
                            _refuse)
        _, out = _run(Tracer())
    assert sorted(len(t) for t in out.values()) == [MAX_NEW] * len(LENS)
    assert trace_mod.region(None, "x") is trace_mod.region(None, "y")

"""`ranges.py` on synthetic events: a kernel goes to the range of the
call that launched it, every idle stretch goes to a range or to
`(outside the engine)`, and busy plus idle is the recording's wall; the
five readers of the ranges and the engine's tallies on a small Window;
and `events` on a CPU profiler."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from ptbench import ranges, spec, testing
from ptbench.window import Window

# host ranges (us): a step holding a decode that holds the layers, which
# hold one layer's kv part; a schedule phase before the decode
RANGES = [(0, 100, "serve.step"), (2, 10, "serve.schedule"),
          (10, 90, "serve.decode"), (12, 80, "model.layers"),
          (20, 30, "layer.attn.kv"), (30, 40, "layer.attn.core")]
STEP = "serve.step/serve.decode"
KV = f"{STEP}/model.layers/layer.attn.kv"
CORE = f"{STEP}/model.layers/layer.attn.core"


def test_a_kernel_goes_to_the_range_that_launched_it():
    # launched at 25 inside the kv range, run by the device at 50-60,
    # when the host is in the layers but no longer in that range
    out = ranges.attribute([(50, 60, 7)], RANGES, {7: 25.0}, (0, 100))
    assert out["ranges"][KV]["busy_s"] == pytest.approx(10e-6)
    assert out["ranges"][f"{STEP}/model.layers"]["busy_s"] == 0.0


def test_every_gap_is_attributed_and_the_wall_adds_up():
    dev = [(5, 8, 1), (25, 35, 2), (33, 45, 3), (70, 72, 4), (95, 99, 5),
           (150, 160, 6)]
    launches = {1: 3.0, 2: 21.0, 3: 31.0, 4: 69.0, 5: 94.0}
    out = ranges.attribute(dev, RANGES, launches, (0, 200))
    r = out["ranges"]
    # busy is the union: 3 + 20 (25-45 merged) + 2 + 4 + 10
    assert out["busy_s"] == pytest.approx(39e-6)
    assert sum(v["busy_s"] for v in r.values()) == pytest.approx(39e-6)
    assert out["busy_s"] + out["idle_s"] == pytest.approx(out["wall_s"])
    assert out["wall_s"] == pytest.approx(200e-6)
    # the overlap 33-35 counts once, for the op that started first
    assert r[KV]["busy_s"] == pytest.approx(10e-6)
    assert r[CORE]["busy_s"] == pytest.approx(10e-6)
    # no launch seen for op 6
    assert r[ranges.UNLAUNCHED]["busy_s"] == pytest.approx(10e-6)
    # gaps at their midpoints: 0-5 (2.5, serve.schedule), 8-25 (16.5,
    # model.layers), 45-70 (57.5, model.layers), 72-95 (83.5,
    # serve.decode), 99-150 and 160-200 (outside every range)
    assert r["serve.step/serve.schedule"]["idle_s"] == pytest.approx(5e-6)
    assert r[f"{STEP}/model.layers"]["idle_s"] == pytest.approx(42e-6)
    assert r[STEP]["idle_s"] == pytest.approx(23e-6)
    assert r[ranges.OUTSIDE]["idle_s"] == pytest.approx(91e-6)
    assert r[KV]["count"] == 1 and r["serve.step"]["count"] == 1
    model, host = ranges.idle_split(r)
    assert model == pytest.approx(42e-6)
    assert model + host == pytest.approx(out["idle_s"])


def test_the_wall_defaults_to_the_ops_and_cuts_them():
    out = ranges.attribute([(10, 20, 1), (30, 40, 2)], RANGES,
                           {1: 11.0, 2: 31.0})
    assert out["wall_s"] == pytest.approx(30e-6)
    assert out["idle_s"] == pytest.approx(10e-6)
    cut = ranges.attribute([(10, 20, 1), (30, 40, 2)], RANGES,
                           {1: 11.0, 2: 31.0}, (15, 35))
    assert cut["busy_s"] == pytest.approx(10e-6)
    assert cut["busy_s"] + cut["idle_s"] == pytest.approx(cut["wall_s"])
    assert ranges.attribute([], [], {})["wall_s"] == 0.0


def test_timeline_paths_of_nested_and_repeated_ranges():
    line = ranges.Timeline(RANGES + [(40, 50, "layer.attn.kv")])
    assert line.at(25) == KV and line.at(45) == KV
    assert line.at(40) == KV and line.at(39.9) == CORE
    assert line.at(85) == STEP and line.at(95) == "serve.step"
    assert line.at(-1) == ranges.OUTSIDE and line.at(100) == ranges.OUTSIDE
    assert line.counts[KV] == 2


def test_events_of_a_cpu_profiler():
    """The harness's own annotations and the profiler's step range are
    not program ranges; the step range is the recording's wall."""
    p = profile(activities=[ProfilerActivity.CPU],
                schedule=schedule(wait=0, warmup=1, active=1))
    p.__enter__()
    p.step()
    with record_function("ptbench.engine_step"):
        with record_function("serve.step"):
            torch.ones(4).sum()
    p.__exit__(None, None, None)
    dev, got, launches, wall = ranges.events(p)
    assert dev == [] and [r[2] for r in got] == ["serve.step"]
    assert wall is not None and wall[0] <= got[0][0] <= got[0][1] <= wall[1]
    out = ranges.attribute(dev, got, launches, wall)
    assert out["busy_s"] == 0.0
    assert out["idle_s"] == pytest.approx(out["wall_s"])


def test_program_counts():
    from repro_torch.core import Tracer
    t = Tracer()
    t.tally("serve.prefill.prompt_tokens", 5)
    assert ranges.program_counts(t) == {"serve.prefill.prompt_tokens": 5}
    assert ranges.program_counts(object()) == {}


def _window(trace=None, counts=None):
    win = Window(t0=0.0, t1=1.0, setup_s=0.0, recs=[], steps=[],
                 attempted=0, failed=0, memory_peak_bytes=0, trace=trace)
    if counts is not None:
        win.program_counts = counts
    return win


def test_the_readers_on_a_small_window():
    out = ranges.attribute(
        [(22, 28, 1), (31, 39, 2), (82, 86, 3)],
        RANGES + [(110, 190, "serve.step"), (120, 180, "serve.decode"),
                  (125, 170, "model.layers"), (130, 140, "layer.attn.kv")],
        {1: 21.0, 2: 31.0, 3: 81.0}, (0, 200))
    trace = {"busy_s": out["busy_s"], "window_s": out["wall_s"],
             "ranges": out["ranges"]}
    counts = {"serve.decode.kv_positions_live": 30,
              "serve.decode.kv_positions_read": 120,
              "serve.prefill.prompt_tokens": 9,
              "serve.prefill.bucket_tokens": 16}
    win = _window(trace, counts)
    read = {m: spec.module("metrics", m).read(win, None) for m in
            ("decode_attn_ms", "kv_read_useful", "prefill_useful",
             "launch_idle_share", "host_idle_share", "idle_share")}
    # 14 us of kv and core over two decode steps
    assert read["decode_attn_ms"] == pytest.approx(7e-3)
    assert read["kv_read_useful"] == pytest.approx(25.0)
    assert read["prefill_useful"] == pytest.approx(56.25)
    assert read["launch_idle_share"] + read["host_idle_share"] == \
        pytest.approx(read["idle_share"])
    assert read["launch_idle_share"] > 0 and read["host_idle_share"] > 0


def test_the_readers_find_nothing_in_a_window_without_them():
    """A program that opens no range and keeps no tally, or a window
    without the trace, gives no reading, and no error."""
    bare = _window({"busy_s": 1.0, "window_s": 2.0, "kernel_s": {}})
    for win in (bare, _window(), _window(counts={})):
        for m in ("decode_attn_ms", "kv_read_useful", "prefill_useful",
                  "launch_idle_share", "host_idle_share"):
            assert spec.module("metrics", m).read(win, None) is None


def test_prefill_useful_of_a_cpu_run():
    """`prefill_useful` of a run's tallies is its prompts' lengths over
    the bucket a prefill."""
    from repro_torch.core import Tracer
    from repro_torch.serve.engine import ServeEngine
    from ptbench.ref import dense
    cfg, arch = testing.smoke("internlm2-20b")
    tracer = Tracer()
    mix = testing.SMOKE_MIX
    eng = ServeEngine(cfg, params=dense.program_tree(
        dense.make_weights(arch, 5, "cpu")), device="cpu", profile=tracer,
        **mix["engine"])
    lens = [4, 7, 12, 9, 5]
    for n in lens:
        eng.submit(torch.arange(1, n + 1).numpy(), 3)
    eng.run()
    win = _window(counts=ranges.program_counts(tracer))
    got = spec.module("metrics", "prefill_useful").read(win, None)
    assert got == pytest.approx(
        100.0 * sum(lens) / (len(lens) * mix["engine"]["prompt_bucket"]))

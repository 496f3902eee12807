"""The port's examples (`examples/pt_*.py`), each run to its end on the
CPU at smoke size, and where it prints a host-side result of the cost
model, held line for line to the reference example's output:

  * pt_quickstart: the SIM collectives' checks and the tiny LM's losses;
  * pt_collectives_showcase: every collective on the 16-PE SIM equal to
    its library analogue, and the modeled stage-time table and the
    alpha-beta fits equal to the reference showcase's;
  * pt_hierarchical_allreduce: its checks, and the cost model's picks
    equal to the reference's;
  * pt_serve_batched: the continuous engine's tokens, those of the serve
    launcher run with the same flags;
  * pt_trace_serve: the engine on a (1, 2) mesh of rank processes, the
    Chrome trace and the metrics valid documents;
  * pt_train_100m (its smoke cut): killed at step 2's batch after its
    step-1 checkpoint, then resumed from it; the killed run's losses
    equal an uninterrupted run's, and two resumes from copies of the
    checkpoint equal each other bit for bit.
"""
import contextlib
import importlib
import io
import json
import runpy
import shutil
import sys
import threading
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _example(name):
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def _run(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = fn(*a, **kw)
    return got, out.getvalue().splitlines()


def test_pt_quickstart():
    losses, lines = _run(_example("pt_quickstart").main,
                         ["--device", "cpu", "--steps", "2"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    for want in ("n_pes: 16", "broadcast(root=5) ok: True",
                 "fcollect shape: (16, 128)", "sum_to_all ok: True",
                 "dissemination barrier rounds: 4"):
        assert want in lines
    assert lines[-1] == f"final loss: {losses[-1]}"


def _modeled(lines):
    """The showcase's table and fit lines (everything after its checks)."""
    first = next(i for i, l in enumerate(lines) if l.lstrip().startswith(
        "bytes"))
    return lines[first:]


def test_pt_collectives_showcase_equals_the_reference():
    fits, lines = _run(_example("pt_collectives_showcase").main,
                       ["--device", "cpu"])
    assert sorted(fits) == ["broadcast", "put", "reduce"]
    checks = [l for l in lines if "library analogue" in l]
    assert len(checks) == 5 and all(l.endswith("True") for l in checks)
    _, want = _run(runpy.run_path, str(EXAMPLES / "collectives_showcase.py"))
    assert _modeled(lines) == _modeled(want)


def test_pt_hierarchical_allreduce_equals_the_reference():
    picks, lines = _run(_example("pt_hierarchical_allreduce").main,
                        ["--device", "cpu"])
    ref = runpy.run_path(str(EXAMPLES / "hierarchical_allreduce.py"),
                         run_name="reference")
    _, want = _run(ref["main"])
    assert lines[-1] == "OK" and picks[64] != picks[1 << 20] == "hier"
    same = [l for l in want if "choose_" in l or l.startswith("mesh")
            or "EXACTLY" in l or "active-set" in l]
    assert len(same) == 7
    assert same == [l for l in lines if "choose_" in l
                    or l.startswith("mesh") or "EXACTLY" in l
                    or "active-set" in l]


def test_pt_serve_batched_is_the_continuous_launcher():
    from repro_torch.launch import serve
    gen, lines = _run(_example("pt_serve_batched").main, ["--device", "cpu"])
    assert gen.shape == (8, 16)
    assert any("(continuous, paged, cpu) generated (8, 16)" in l
               for l in lines)
    want, _ = _run(serve.main, [
        "--arch", "qwen2-0.5b", "--smoke", "--continuous", "--requests",
        "8", "--rate", "2", "--slots", "4", "--prompt-len", "16",
        "--tokens", "16", "--cache-len", "64", "--page-size", "8",
        "--device", "cpu"])
    np.testing.assert_array_equal(gen, want)


def test_pt_trace_serve_writes_valid_documents(tmp_path):
    from repro_torch.tools.tracereport import validate_metrics, validate_trace
    got, lines = _run(_example("pt_trace_serve").main,
                      ["--device", "cpu", "--out-dir", str(tmp_path)])
    assert lines[0] == "[trace_serve] served 4 requests in " \
        f"{lines[0].split(' in ')[1]}"
    assert sorted(len(v) for v in got["results"].values()) == [6] * 4
    assert got["flows"] > 0
    trace = json.loads(Path(got["trace"]).read_text())
    metrics = json.loads(Path(got["metrics"]).read_text())
    assert validate_trace(trace) == [] and validate_metrics(metrics) == []
    assert lines[-1] == "[trace_serve] open the trace at " \
        "https://ui.perfetto.dev"


TRAIN_ARGS = ["--smoke", "--steps", "3", "--ckpt-every", "1", "--seq-len",
              "16", "--batch", "2", "--device", "cpu"]


def _losses_printed(lines):
    """Each "[train] step" line's step and loss, as printed."""
    return [l.split("(")[0].split() for l in lines
            if l.startswith("[train] step")]


@pytest.fixture
def registry_restored():
    """pt_train_100m registers its arch in the port's shared registry (and
    its config module in sys.modules), as the reference example does;
    both are taken out again after the test, so that later tests see the
    ten archs of the reference's registry."""
    from repro_torch.configs import registry
    try:
        with mock.patch.dict(registry.ARCHS):
            yield
    finally:
        sys.modules.pop("repro_torch.configs._tmp100m", None)


def test_pt_train_100m_is_killed_and_resumes(tmp_path, registry_restored):
    from repro_torch.data import pipeline
    mod = _example("pt_train_100m")
    whole, whole_lines = _run(mod.main, TRAIN_ARGS + [
        "--ckpt-dir", str(tmp_path / "whole")])
    assert len(whole) == 3 and np.isfinite(whole).all()

    real = pipeline.SyntheticLM.batch

    def killed_at_2(self, step):
        if step == 2:
            raise KeyboardInterrupt("killed at step 2's batch")
        return real(self, step)

    out = io.StringIO()
    with mock.patch.object(pipeline.SyntheticLM, "batch", killed_at_2), \
            contextlib.redirect_stdout(out), \
            pytest.raises(KeyboardInterrupt):
        mod.main(TRAIN_ARGS + ["--ckpt-dir", str(tmp_path / "run")])
    assert _losses_printed(out.getvalue().splitlines()) == \
        _losses_printed(whole_lines)[:2]
    for t in threading.enumerate():      # the step-1 save, written async
        if t is not threading.current_thread() and not t.daemon:
            t.join()
    ckpts = sorted(p.name for p in (tmp_path / "run").iterdir()
                   if p.name.startswith("step-"))
    assert ckpts == ["step-00000001"]
    shutil.copytree(tmp_path / "run", tmp_path / "copy")
    resumed, lines = _run(mod.main, TRAIN_ARGS + ["--ckpt-dir",
                                                  str(tmp_path / "run")])
    again, _ = _run(mod.main, TRAIN_ARGS + ["--ckpt-dir",
                                           str(tmp_path / "copy")])
    assert "[train] resumed from step 1" in lines
    assert len(resumed) == 2 and np.isfinite(resumed).all()
    assert resumed == again

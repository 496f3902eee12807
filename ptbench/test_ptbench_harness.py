"""The harness on the CPU at the port's smoke sizes: the plain reference
against the port's ServeEngine, a run judged correct, each fault of the
timed path judged not correct, the control failing the cells' limits,
no run without a card, no JAX in a run, and every name of
BENCHMARK.json found as a file."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ptbench import ROOT, judge, spec, testing
from ptbench.ref import dense

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
ARCHS = {"internlm2-20b": "internlm2-20b.chat",
         "phi-3-vision-4.2b": "phi-3-vision-4.2b.rag"}


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread a test: the smoke runs are timed windows, and
    workers that each take every core slow each other's windows down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_of_other_tests(monkeypatch):
    """Test files run before this one in the same worker may have loaded
    JAX: a run here refuses only what it loads itself (a whole run's
    process is checked by `test_no_jax_module_is_loaded`)."""
    from ptbench import run
    before = set(run.loaded_forbidden())
    found = run.loaded_forbidden
    monkeypatch.setattr(run, "loaded_forbidden",
                        lambda: [m for m in found() if m not in before])


def _execute(arch_name, seed, **kw):
    from ptbench import run
    cfg, arch = testing.smoke(arch_name)
    return run.execute(ARCHS[arch_name], seed, 0.5, False, device="cpu",
                       arch=arch, cfg=cfg, mix=testing.SMOKE_MIX, **kw)


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_reference_matches_the_port_in_f32(arch_name):
    from repro_torch.serve.engine import ServeEngine
    cfg, arch = testing.smoke(arch_name, dtype=torch.float32)
    w = dense.make_weights(arch, 2**31 + 5, "cpu")
    eng = ServeEngine(cfg, params=dense.program_tree(w), device="cpu",
                      capture_logits=True, **testing.SMOKE_MIX["engine"])
    rng = np.random.default_rng(0)
    prompts = {eng.submit(p, 5): p for p in
               (rng.integers(0, cfg.vocab, n) for n in (5, 12, 16))}
    out = eng.run()
    for rid, prompt in prompts.items():
        seq = torch.as_tensor(np.concatenate([prompt, out[rid][:-1]]))
        ref = dense.logits(w, arch, seq, len(prompt) - 1)
        got = torch.as_tensor(np.stack(eng.logits_trace[rid]))
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_a_run_is_judged_correct(arch_name):
    out = _execute(arch_name, 2**31 + 9)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    checks = out["checks"]
    assert checks["widest_gap"]["value"] < 0.05
    assert checks["tokens_checked"]["value"] >= 9
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]


def _kv_unchanged(mp):
    from repro_torch.models import layers
    mp.setattr(layers, "paged_kv_update", lambda leaf, *a, **k: leaf)


def _half_batch(mp):
    from repro_torch.models import transformer
    orig = transformer.decode_step_paged

    def half(comm, cfg, params, pool, table, toks, pos, **kw):
        b = toks.shape[0] // 2
        lg, pool = orig(comm, cfg, params, pool, table[:b], toks[:b],
                        pos[:b], **kw)
        return torch.cat([lg, lg.mean(0, keepdim=True).expand(
            toks.shape[0] - b, *lg.shape[1:])]), pool
    mp.setattr(transformer, "decode_step_paged", half)


def _token_altered(mp):
    from repro_torch.serve import step
    orig = step.sample_greedy
    mp.setattr(step, "sample_greedy",
               lambda comm, lg: (orig(comm, lg) + 1) % lg.shape[-1])


@pytest.mark.parametrize("fault", [_kv_unchanged, _half_batch,
                                   _token_altered])
def test_a_broken_timed_path_is_judged_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _execute("internlm2-20b", 2**31 + 9)
    assert not out["correct"]
    assert out["checks"]["widest_gap"]["value"] > \
        out["checks"]["widest_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limit(cell):
    """The reference in float8 judged in the program's place, through the
    harness's comparison, at a size a CPU holds (d 512, 8 layers,
    vocabulary 4096; a request of 100 served tokens): it comes out not
    correct at the cell's limit on each of three seeds."""
    arch = {"reference": "dense", "hidden_size": 512,
            "num_hidden_layers": 8, "num_attention_heads": 8,
            "num_key_value_heads": 4, "head_dim": 64,
            "intermediate_size": 1024, "vocab_size": 4096,
            "rope_theta": 1e6, "rms_norm_eps": 1e-6,
            "torch_dtype": "float32"}
    limit = spec.limits(cell)["widest_gap"]["limit"]
    ref, _ = spec.family(arch)
    rec = dataclasses.make_dataclass("Rec", ["prompt", "tokens"])
    for seed in (1, 2, 3):
        w = ref.make_weights(arch, seed, "cpu")
        toks = np.random.default_rng(seed).integers(0, 4096, 200)
        served = rec(toks[:101], np.append(toks[101:], 0))
        sides = judge.judge(ref, w, arch, [served], 1, seed, "cpu", limit,
                            sides=("control",))
        assert sides["control"]["tokens_checked"]["value"] == 100
        assert not judge.passed(sides["control"])


def test_a_run_without_a_card_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "ptbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "{" not in p.stdout and "metrics" not in p.stdout


def test_no_jax_module_is_loaded():
    code = (
        "import sys, importlib, pathlib\n"
        "sys.path[:0] = ['src', '.']\n"
        "import ptbench.run, ptbench.judge, ptbench.calibrate\n"
        "import ptbench.ref.dense, ptbench.loads.serve_closed_loop\n"
        "import ptbench.counts.dense\n"
        "import repro_torch.serve.engine\n"
        "for kind in ('metrics', 'e2e'):\n"
        "    for f in pathlib.Path('ptbench', kind).glob('*.py'):\n"
        "        importlib.import_module(f'ptbench.{kind}.{f.stem}')\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro'})\n"
        "print(bad)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_every_name_is_a_file():
    b = spec.benchmark()
    here = ROOT / "ptbench"
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        arch = spec.config(c["name"])
        assert arch["source"] == c["source"]
        assert sorted(arch["reduced"]) == sorted(c["reduced"])
        spec.program_config(arch)          # the port runs the file's sizes
    for w in b["workloads"]:
        assert (here / "traffic" / f"{w['traffic']}.json").is_file()
        assert spec.limits(w["name"])["widest_gap"]["limit"] > 0
    for m in b["end_to_end"]:
        assert m["name"] == "setup_s" or \
            (here / "e2e" / f"{m['name']}.py").is_file()
    for m in b["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    assert json.loads(json.dumps(b)) == b


def test_each_configuration_finds_its_family():
    """A configuration's `"reference"` names its family: `ref/<f>.py` and
    `counts/<f>.py`, found by that name, with what the harness calls."""
    for c in spec.benchmark()["configs"]:
        arch = spec.config(c["name"])
        ref, counts = spec.family(arch)
        assert ref.__file__.endswith(f"ref/{arch['reference']}.py")
        assert counts.__file__.endswith(f"counts/{arch['reference']}.py")
        for fn in ("make_weights", "program_tree", "check_program",
                   "logits"):
            assert callable(getattr(ref, fn))
        for fn in ("prefill_flops", "token_flops", "attention_flops",
                   "attention_bytes", "bound_seconds"):
            assert callable(getattr(counts, fn))
    assert spec.module("ref", "dense") is spec.module("ref", "dense")

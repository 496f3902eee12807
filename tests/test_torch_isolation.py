"""The port stands alone: no file of `src/repro_torch/`, not
`chip_smoke.py` and no `examples/pt_*.py` imports jax or the JAX package,
and the serving path, the runtime and the training path run in a process
where neither can be imported."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}
PT_FILES = sorted((ROOT / "examples").glob("pt_*.py"))
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + PT_FILES + [
    ROOT / "examples" / "run_pt_examples.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_exist():
    assert len(FILES) > 15
    assert [p.stem for p in PT_FILES] == [
        "pt_collectives_showcase", "pt_hierarchical_allreduce",
        "pt_quickstart", "pt_serve_batched", "pt_trace_serve",
        "pt_train_100m"]
    for name in ("flash_attention", "put_copy", "reduce_combine",
                 "fused_update", "ring_attention", "ssd_scan"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
                / f"{name}.cu").is_file()


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


BLOCKED = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None          # any import of them now fails
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import convert
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(smoke_config("qwen2-0.5b"), device="cpu", max_slots=2,
                      page_size=8, max_seq=32, prompt_bucket=16)
    rid = eng.submit(np.arange(1, 6), 3)
    assert len(eng.run()[rid]) == 3
    print("ALONE-OK")
""")


def test_serving_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", BLOCKED], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "ALONE-OK" in r.stdout


RUNTIME_BLOCKED = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None          # any import of them now fails
    import torch
    from repro_torch.core import sim_ctx
    ctx = sim_ctx(4, device="cpu")
    x = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    for algo in ("rd", "ring"):
        out = ctx.to_all(x, "sum", algorithm=algo)
        assert torch.equal(out, x.sum(0, dtype=torch.int32).expand(4, 3))
    print("RUNTIME-ALONE-OK")
""")


def test_runtime_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", RUNTIME_BLOCKED], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "RUNTIME-ALONE-OK" in r.stdout


TRAIN_BLOCKED = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None          # any import of them now fails
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.train import step as tstep
    from repro_torch.data.pipeline import SyntheticLM
    losses = train.main(["--arch", "qwen2-0.5b", "--smoke", "--device",
                         "cpu", "--steps", "3", "--seq-len", "16",
                         "--batch", "4"])
    assert np.isfinite(losses).all() and len(losses) == 3
    cfg = smoke_config("qwen2-0.5b")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    step = tstep.build_train_step(cfg, grad_rs="fused")
    loss, params, state = step(params, tstep.init_fused_opt_state(params),
                               SyntheticLM(cfg.vocab, 16, 4).batch(0))
    assert np.isfinite(float(loss))
    print("TRAIN-ALONE-OK")
""")


def test_training_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", TRAIN_BLOCKED], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "TRAIN-ALONE-OK" in r.stdout


SPMD_ALONE = textwrap.dedent("""
    import numpy as np
    from repro_torch.launch import train
    losses = train.main(["--arch", "qwen2-0.5b", "--smoke", "--device",
                         "cpu", "--steps", "2", "--seq-len", "16",
                         "--batch", "4", "--data", "2", "--model", "2"])
    assert np.isfinite(losses).all() and len(losses) == 2
    print("SPMD-ALONE-OK")
""")


def test_spmd_backend_runs_without_jax_or_repro(tmp_path):
    """The launcher on a 2x2 mesh of rank processes, with jax, jaxlib and
    repro shadowed by packages that refuse to import, on the parent's
    path and so on every rank's."""
    for name in ("jax", "jaxlib", "repro"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{ROOT / 'src'}")
    r = subprocess.run([sys.executable, "-c", SPMD_ALONE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "SPMD-ALONE-OK" in r.stdout

#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:
  1. setup — torch, CUDA and nvcc versions, the card's name and power
     limit, and the build of every kernel from the sources in this
     checkout (one nvcc per source, all started together);
  2. kernels — each kernel against its plain PyTorch version on the card,
     at the serving path's shapes and over a grid of edge cases, with the
     tolerance stated per dtype; then timed beside its plain version and
     one PyTorch library call (a yardstick the port never calls);
  3. serve — qwen2-0.5b at full width (24 layers, vocab 151936) with
     seeded random weights: 8 requests of 100 prompt tokens (bucket 128),
     32 new tokens each, 4 slots, page size 16, max_seq 256 (the run
     `repro_torch/configs/qwen2_0_5b.py` names).  Every
     launch count is set to 0 just before this run and read just after;
     the run must have gone through every kernel of the path.  Then two
     requests served alone must give the batched run's tokens bit for
     bit, and one request's prefill logits through the kernel must match
     those through the plain version.

The last lines are one JSON object per kernel run ({"kernels": [...]}),
the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
KERNELS = ["flash_attention"]

# published peaks of one H100 SXM (dense): bytes over 3.35 TB/s, products
# over the tensor-core rate of their type (bf16) or the f32 CUDA-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": 3e-5, "torch.bfloat16": 3e-2}
# prefill logits through the kernel vs through the plain version, relative
# to the largest logit: 8 bf16 ulps (2^-8 relative spacing each)
PREFILL_LOGITS_RTOL = 8 * 2.0 ** -8
# q and k at 2.5x unit scale (v at unit scale) give logits of std ~6: the
# softmax is peaked, softcap moves the output by several tolerances (each
# softcap case checks that it does), and |out| is far above the tolerance
QK_SCALE = 2.5


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of `fn` over back-to-back calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: flash attention against its plain version
# ---------------------------------------------------------------------------

ATTN_CASES = [dict(causal=True), dict(causal=False),
              dict(causal=True, window=17), dict(causal=True, softcap=30.0),
              dict(causal=True, window=33, softcap=50.0)]


def attention_inputs(torch, gen, b, hq, hkv, lq, lk, d, dt):
    def rnd(scale, *shape):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dt)
    return (rnd(QK_SCALE, b, hq, lq, d), rnd(QK_SCALE, b, hkv, lk, d),
            rnd(1.0, b, hkv, lk, d))


def attention_cases():
    """(label, B, Hkv, group, Lq, Lk, D, dtype name, kwargs)."""
    cases = [("slice", 1, 2, 7, 128, 256, 64, "bfloat16", dict(causal=True)),
             ("slice_ragged", 1, 2, 7, 100, 100, 64, "bfloat16",
              dict(causal=True)),
             ("slice_noncausal", 1, 2, 7, 128, 256, 64, "bfloat16",
              dict(causal=False)),
             ("slice_f32", 1, 2, 7, 128, 256, 64, "float32",
              dict(causal=True))]
    for kw in ATTN_CASES:
        for lq, lk, group in [(64, 64, 2), (100, 100, 1), (32, 96, 4)]:
            if kw.get("causal") and lq != lk:
                continue          # causal assumes aligned positions
            for dtype in ("float32", "bfloat16"):
                cases.append((f"grid{lq}x{lk}g{group}", 2, 2, group, lq, lk,
                              32, dtype, kw))
    for d in (16, 128):
        for dtype in ("float32", "bfloat16"):
            cases.append((f"hd{d}", 1, 2, 2, 96, 160, d, dtype,
                          dict(causal=True, window=40)))
    return cases


def mask_counts(lq: int, lk: int, causal: bool, window) -> tuple[int, int]:
    """(query-key pairs, keys) the mask keeps: the products the function
    needs, and the K/V rows some query reads (those past every row's
    causal edge or before every row's window are never needed)."""
    pairs, lo_min, hi_max = 0, lk, -1
    for i in range(lq):
        lo = max(0, i - window + 1) if window is not None else 0
        hi = min(i, lk - 1) if causal else lk - 1
        if hi >= lo:
            pairs += hi - lo + 1
            lo_min, hi_max = min(lo_min, lo), max(hi_max, hi)
    return pairs, max(0, hi_max - lo_min + 1)


def check_attention(torch, ops, ref, gen) -> dict:
    worst = {}
    for label, b, hkv, group, lq, lk, d, dtype, kw in attention_cases():
        dt = getattr(torch, dtype)
        q, k, v = attention_inputs(torch, gen, b, hkv * group, hkv, lq, lk,
                                   d, dt)
        out = ops.attention(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        if out.shape != want.shape or out.dtype != want.dtype:
            raise AssertionError(f"{label}: {out.shape}/{out.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label} {kw}: non-finite output")
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[str(dt)]
        typical = want.float().abs().mean().item()
        log(f"  attention {label:16s} {dtype:8s} B{b} Hq{hkv * group} "
            f"Hkv{hkv} Lq{lq} Lk{lk} D{d} {kw}: max|err| {err:.3e} "
            f"(tol {tol:g}, mean|out| {typical:.3f})")
        if not err <= tol:
            raise AssertionError(f"{label} {dtype} {kw}: max|err| {err} > "
                                 f"{tol}")
        if not typical > 10 * tol:
            raise AssertionError(f"{label} {dtype}: mean|out| {typical} is "
                                 f"not far above the tolerance {tol}")
        if "softcap" in kw:
            blind = ref.attention_ref(q, k, v, **{**kw, "softcap": None})
            gap = (blind.float() - want.float()).abs().max().item()
            if not gap > 2 * tol:
                raise AssertionError(f"{label} {dtype} {kw}: dropping the "
                                     f"softcap moves the output by {gap}, "
                                     f"not more than twice the tolerance")
        worst[label + dtype] = err
    return worst


def time_attention(torch, fa, ref, gen) -> dict:
    """Times at the serving prefill's shapes: the kernel alone (its C
    entry called back to back), the wrapper, the plain version, and
    scaled_dot_product_attention as the library yardstick."""
    import torch.nn.functional as F
    b, hq, hkv, lq, lk, d = 1, 14, 2, 128, 256, 64
    dt = torch.bfloat16
    q, k, v = attention_inputs(torch, gen, b, hq, hkv, lq, lk, d, dt)
    scale = 1.0 / math.sqrt(d)
    out = fa.flash_attention(q, k, v, causal=True, sm_scale=scale)
    want = ref.attention_ref(q, k, v, causal=True, sm_scale=scale)
    err = (out.float() - want.float()).abs().max().item()

    lib = fa._library()
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b,
            hq, hkv, lq, lk, d, lk, 1, 0, 0.0, scale, stream)
    kernel_ms = time_ms(lambda: lib.repro_flash_attention_fwd(*args))
    wrapper_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                                    sm_scale=scale))
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=True,
                                                 sm_scale=scale))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, scale=scale, enable_gqa=True)
    sdpa_err = (sdpa().float() - want.float()).abs().max().item()
    library_ms = time_ms(sdpa)

    # q read and out written once; of k and v only the rows the causal
    # mask keeps (keys 0..Lq-1 of Lk): the rest is never needed
    pairs, keys = mask_counts(lq, lk, True, None)
    nbytes = (q.numel() + out.numel() + 2 * b * hkv * keys * d) \
        * q.element_size()
    ops_count = 4 * d * pairs * b * hq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS_PER_S[str(dt)] * 1e3
    log(f"  times at B{b} Hq{hq} Hkv{hkv} Lq{lq} Lk{lk} D{d} bf16 causal: "
        f"kernel {kernel_ms:.5f} ms, wrapper {wrapper_ms:.5f} ms, plain "
        f"{plain_ms:.5f} ms, sdpa {library_ms:.5f} ms (sdpa max|err| vs "
        f"plain {sdpa_err:.3e}); bound {max(t_bytes, t_ops):.6f} ms "
        f"({nbytes} B, {ops_count} products-ops, {keys} of {lk} keys)")
    return dict(max_abs_err=err, ms=kernel_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------

def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def serve(torch, np, fa, serving, ServeEngine):
    cfg, engine_kw = serving.CONFIG, serving.SERVE_ENGINE
    n_requests, prompt_len, new_tokens = (
        serving.SERVE_TRAFFIC[k] for k in ("requests", "prompt_len",
                                           "new_tokens"))
    eng = ServeEngine(cfg, device="cuda", init_seed=0, **engine_kw)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(n_requests, prompt_len),
                           dtype=np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.launches = 0                                  # main path starts
    t0 = time.perf_counter()
    rids = [eng.submit(p, new_tokens) for p in prompts]
    got_at = {rid: [] for rid in rids}               # host times of tokens
    while not eng.scheduler.idle():
        before = {st.rid: len(st.out) for st in eng.scheduler.slots
                  if st is not None}
        eng.step()
        now = time.perf_counter()
        for st in eng.scheduler.slots:
            if st is not None and len(st.out) > before.get(st.rid, 0):
                got_at[st.rid].append(now)
    eng.run()                                        # final evict pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches}      # main path ends
    peak = torch.cuda.max_memory_allocated()

    n_prefill = eng.scheduler.n_admitted
    if launches["flash_attention"] != cfg.n_layers * n_prefill:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, want "
                             f"{cfg.n_layers} x {n_prefill} prefills")
    for rid in rids:
        if len(eng.results[rid]) != new_tokens:
            raise AssertionError(f"request {rid}: {len(eng.results[rid])} "
                                 f"tokens, want {new_tokens}")
    ttft = [got_at[r][0] - t0 for r in rids]
    gaps = [b - a for r in rids for a, b in zip(got_at[r], got_at[r][1:])
            if b > a]
    n_tok = sum(len(eng.results[r]) for r in rids)
    log(f"  served {n_requests} requests x {new_tokens} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tok/s, TTFT p50 "
        f"{pct(ttft, 50) * 1e3:.2f} ms (submit to the end of the admitting "
        f"step), per-token p50 {pct(gaps, 50) * 1e3:.3f} ms, peak memory "
        f"{peak / 2**30:.3f} GiB, {eng.steps} engine steps, "
        f"{n_prefill} prefills, flash_attention launches "
        f"{launches['flash_attention']}")

    # two requests alone: tokens bit-identical to the batched run
    solo = ServeEngine(cfg, params=eng.params, device="cuda", **engine_kw)
    for rid in rids[:2]:
        s = solo.submit(prompts[rid], new_tokens)
        solo.run()
        if not np.array_equal(solo.results[s], eng.results[rid]):
            raise AssertionError(f"request {rid}: alone "
                                 f"{solo.results[s].tolist()} != batched "
                                 f"{eng.results[rid].tolist()}")
    log("  batched == alone, bit for bit, for requests "
        f"{rids[:2]}")
    return eng, prompts, launches


def prefill_logits_check(torch, np, ref, layers, eng, prompts, serving,
                         ServeEngine):
    """One request's prefill logits through the kernel and through the
    plain version (ops.attention swapped for ref.attention_ref)."""
    cfg = serving.CONFIG

    def first_logits():
        e = ServeEngine(cfg, params=eng.params, device="cuda",
                        capture_logits=True, **serving.SERVE_ENGINE)
        r = e.submit(prompts[0], 1)
        e.run()
        return e.logits_trace[r][0]

    kernel = first_logits()
    with mock.patch.object(layers.kops, "attention", ref.attention_ref):
        plain = first_logits()
    if kernel.shape != (cfg.vocab,) or not np.isfinite(kernel).all():
        raise AssertionError(f"prefill logits {kernel.shape}, finite "
                             f"{np.isfinite(kernel).all()}")
    err = float(np.abs(kernel - plain).max())
    scale = float(np.abs(plain).max())
    log(f"  prefill logits kernel vs plain: max|err| {err:.4e}, "
        f"max|logit| {scale:.4f}, tol {PREFILL_LOGITS_RTOL * scale:.4e}; "
        f"argmax {int(kernel.argmax())} vs {int(plain.argmax())}")
    if not err <= PREFILL_LOGITS_RTOL * scale:
        raise AssertionError(f"prefill logits differ by {err}")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return fail(f"torch missing: {e}")
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"{ROOT} is not a checkout of the repository "
                    f"(no src/repro_torch)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import qwen2_0_5b as serving
    from repro_torch.kernels import _build, ref, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: setup")
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    log(f"  card: {torch.cuda.get_device_name(0)} ({card}), "
        f"{torch.cuda.device_count()} visible")
    t = time.perf_counter()
    libs = {name: _build.build(name) for name in KERNELS}
    log(f"  built {KERNELS} in {time.perf_counter() - t:.1f} s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_attention(torch, ops, ref, gen)
    timing = time_attention(torch, fa, ref, gen)

    log(f"== phase 3: serve {serving.CONFIG.name} at full width")
    eng, prompts, launches = serve(torch, np, fa, serving, ServeEngine)
    prefill_logits_check(torch, np, ref, layers, eng, prompts, serving,
                         ServeEngine)

    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:79",
        launches=launches["flash_attention"],
        max_abs_err=timing["max_abs_err"], ms=timing["ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"])]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

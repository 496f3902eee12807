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
     those through the plain version;
  4. runtime kernels — put_copy, dma_copy (kernels 1-2, csrc/put_copy.cu)
     and reduce_combine (kernel 3) against their plain versions, bit for
     bit, over the CPU tests' shapes, ragged edges (1 row, 1 column, odd
     byte widths, unaligned rows), f32/i32/bf16/f64 (and more for the
     combine), NaN for max/min, and 64 MiB buffers; then timed at the
     runtime's real size beside the plain version and one PyTorch call;
  5. runtime — the OpenSHMEM SIM runtime on 16 PEs of the paper's 4x4
     mesh (sim_ctx, plain and with NoC waves): the paper's message-size
     sweep (8 B .. 16 KB per PE) of put, get, put_nbi + quiet, fence,
     barrier_all, broadcast, fcollect, collect, to_all (rd, ring; i32 and
     f32), reduce_scatter + allgather_unpad and alltoall, each checked on
     the host against numpy; then the trainer's 64 MiB-per-PE gradient
     bucket (1 GiB PE-stacked) through to_all rd and ring and
     reduce_scatter + allgather_unpad.  Every launch count is set to 0
     just before this phase and read just after; each must equal the
     count the runtime's own schedules imply.  Then the wall time of a
     few single calls at 8 B and 16 KB per PE.

The last lines are one JSON object per kernel run ({"kernels": [...]}),
the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
KERNELS = ["flash_attention", "put_copy", "reduce_combine"]

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


# ---------------------------------------------------------------------------
# phase 4: the runtime's kernels against their plain versions
# ---------------------------------------------------------------------------

RUNTIME_KERNELS = [
    ("put_copy", "src/repro_torch/kernels/csrc/put_copy.cu",
     "src/repro/kernels/put_copy.py:37"),
    ("dma_copy", "src/repro_torch/kernels/csrc/put_copy.cu",
     "src/repro/kernels/put_copy.py:59"),
    ("reduce_combine", "src/repro_torch/kernels/csrc/reduce_combine.cu",
     "src/repro/kernels/reduce_combine.py:39"),
]
# the runtime's real size: the trainer's gradient-sync bucket, 64 MiB of
# f32 per PE (BUCKET_BYTES, src/repro/train/step.py:36), on the paper's 16
# PEs: 1 GiB of PE-stacked payload
BUCKET_ELEMS = (64 << 20) // 4


def rand(torch, gen, shape, dtype):
    """Seeded values of `dtype` on the card (floats at 100x unit scale)."""
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen, device="cuda") * 100
                ).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -(1 << 30)), min(info.max, 1 << 30),
                         shape, generator=gen, device="cuda",
                         dtype=torch.int64).to(dtype)


def bitwise(torch, got, want, what: str) -> None:
    """Kernel output == plain output value for value (NaN where NaN)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    if want.dtype.is_floating_point:
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan) or \
                not torch.equal(got[~nan], want[~nan]):
            raise AssertionError(f"{what}: kernel != plain version")
    elif not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel != plain version")


def check_runtime_kernels(torch, gen) -> None:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    cases = {"put_copy": 0, "dma_copy": 0, "reduce_combine": 0}
    f32, i32, bf16, f64 = (torch.float32, torch.int32, torch.bfloat16,
                           torch.float64)
    # put_copy: identity, source-row tables with zero rows and more rows
    # out than in, rows at a stride (unaligned row starts)
    for shape in [(37, 300), (100, 1), (1, 513), (1, 1), (7, 37),
                  (16, 4096)]:
        for dt in (f32, i32, bf16, f64, torch.uint8):
            x = rand(torch, gen, shape, dt)
            tables = [None, torch.randint(-1, shape[0], (shape[0] + 3,),
                                          generator=gen, device="cuda",
                                          dtype=torch.int32)]
            for rows in tables:
                bitwise(torch, pc.put_copy(x, rows),
                        ref.put_copy_ref(x, rows), f"put_copy {shape} {dt}")
                cases["put_copy"] += 1
            if shape[1] > 1:
                bitwise(torch, pc.put_copy(x[:, 1:], tables[1]),
                        ref.put_copy_ref(x[:, 1:], tables[1]),
                        f"put_copy strided {shape} {dt}")
                cases["put_copy"] += 1
            bitwise(torch, ops.put_copy(x), x, f"ops.put_copy {shape} {dt}")
    # dma_copy: the CPU tests' descriptor, ragged regions, 1 row, 1
    # column, and a batch of 96 descriptors in one launch
    batch = [[r, c, 95 - r, 383 - c - 1, 1, 2] for r in range(0, 64, 2)
             for c in (0, 77, 201)]
    for descs in ([[32, 128, 0, 256, 32, 128]], [[3, 5, 7, 11, 13, 17]],
                  [[63, 0, 0, 0, 1, 256]], [[0, 255, 1, 1, 64, 1]], batch):
        for dt in (f32, f64, i32, bf16, torch.uint8):
            src = rand(torch, gen, (64, 256), dt)
            dst = rand(torch, gen, (96, 384), dt)
            plan = pc.DmaPlan(descs, src.shape, dst.shape)
            bitwise(torch, pc.dma_copy(src, dst.clone(), plan),
                    ref.dma_copy_ref(src, dst.clone(), plan.descs),
                    f"dma_copy {descs[0]} x{len(descs)} {dt}")
            cases["dma_copy"] += 1
    # reduce_combine: k in {2, 3, 5} x 4 ops x 6 dtypes, rows at a
    # stride, more buffers than one launch takes, NaN for max/min
    for dt in (f32, f64, bf16, torch.float16, i32, torch.int64):
        for op in ("sum", "prod", "max", "min"):
            for k in (2, 3, 5):
                bufs = [torch.randn((40, 200), generator=gen,
                                    device="cuda").to(dt)
                        if dt.is_floating_point
                        else rand(torch, gen, (40, 200), dt)
                        for _ in range(k)]
                bitwise(torch, rc.reduce_combine(bufs, op),
                        ref.reduce_combine_ref(bufs, op),
                        f"reduce_combine {dt} {op} k{k}")
                cases["reduce_combine"] += 1
    wide = rand(torch, gen, (16, 1000), f32)
    blocks = [wide[:, 25 * t:25 * (t + 1)] for t in range(40)]
    bitwise(torch, rc.reduce_combine(blocks, "sum"),
            ref.reduce_combine_ref(blocks, "sum"), "reduce_combine k40")
    nan = torch.tensor([[1.0, float("nan"), 3.0, -1.0, float("nan")]],
                       device="cuda")
    other = torch.tensor([[float("nan"), 2.0, 1.0, float("nan"), 0.5]],
                         device="cuda")
    for dt in (f32, bf16):
        for op in ("max", "min"):
            got = rc.reduce_combine([nan.to(dt), other.to(dt)], op)
            bitwise(torch, got, ref.reduce_combine_ref(
                [nan.to(dt), other.to(dt)], op), f"NaN {op} {dt}")
            if int(torch.isnan(got).sum()) != 4:
                raise AssertionError(f"NaN {op} {dt}: {got.tolist()}")
    cases["reduce_combine"] += 6
    # 64 MiB per buffer
    big = rand(torch, gen, (16, 1 << 20), f32)
    ring = torch.tensor([(i - 1) % 16 for i in range(16)], dtype=torch.int32,
                        device="cuda")
    bitwise(torch, pc.put_copy(big, ring), ref.put_copy_ref(big, ring),
            "put_copy 64 MiB")
    B = (1 << 20) // 16
    plan = pc.DmaPlan([[p, ((p + t) % 16) * B, p, t * B, 1, B]
                       for p in range(16) for t in range(16)],
                      big.shape, big.shape)
    bitwise(torch, pc.dma_copy(big, torch.empty_like(big), plan),
            ref.dma_copy_ref(big, torch.empty_like(big), plan.descs),
            "dma_copy 64 MiB")
    big2 = rand(torch, gen, (16, 1 << 20), f32)
    bitwise(torch, rc.reduce_combine([big, big2], "sum"),
            ref.reduce_combine_ref([big, big2], "sum"),
            "reduce_combine 64 MiB")
    torch.cuda.synchronize()
    log(f"  bit for bit with the plain versions: {cases} cases, plus "
        f"strided/k40/NaN combines and 64 MiB buffers of each kernel")


def time_runtime_kernels(torch, gen) -> dict:
    """Each kernel at the shapes the 1 GiB bucket gives it on the main
    path: put_copy = one delivery of the rd allreduce's first stage
    (16 rows of 64 MiB), dma_copy = the ring reduce-scatter's
    pre-rotation (256 descriptors of 4 MiB), reduce_combine = one rd
    stage combine (two 1 GiB buffers).  The kernel alone is its C entry
    called back to back; the plain version is `kernels/ref.py`; the
    library call is one PyTorch op computing the same function."""
    import ctypes
    import numpy as np
    from repro_torch.core import collectives as coll
    from repro_torch.core.pattern import xor_pattern
    from repro_torch.kernels import ref
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    n, L = 16, BUCKET_ELEMS
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.randn((n, L), generator=gen, device="cuda")
    nbytes = x.numel() * x.element_size()
    out = {}

    def row(name, err, ms, plain_ms, library_ms, moved, what):
        bound = moved / HBM_BYTES_PER_S * 1e3
        log(f"  {name} at {what}: kernel {ms:.5f} ms, plain {plain_ms:.5f} "
            f"ms, library {library_ms:.5f} ms; bound {bound:.5f} ms "
            f"({moved} B at 3.35 TB/s), max|err| {err}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound,
                         bound_by="bytes")

    lib = pc._library()
    table = xor_pattern(n, 1).gather_table_device(x.device)
    y = torch.empty_like(x)
    got = pc.put_copy(x, table)
    err = float((got - ref.put_copy_ref(x, table)).abs().max())
    idx = table.long()
    if not torch.equal(torch.index_select(x, 0, idx), got):
        raise AssertionError("index_select != put_copy")
    del got
    row("put_copy",
        err, time_ms(lambda: lib.repro_put_copy(
            x.data_ptr(), y.data_ptr(), table.data_ptr(), n, L * 4, L * 4,
            stream), iters=20, warmup=3),
        time_ms(lambda: ref.put_copy_ref(x, table), iters=10, warmup=2),
        time_ms(lambda: torch.index_select(x, 0, idx), iters=20, warmup=3),
        2 * nbytes, "16 x 64 MiB f32, one delivery")

    rank = np.arange(n)
    plan = coll._plan("take", (rank[:, None] + rank) % n, 1, L // n, n, n)
    got = pc.dma_copy(x, torch.empty_like(x), plan)
    err = float((got - ref.dma_copy_ref(x, torch.empty_like(x),
                                         plan.descs)).abs().max())
    blk = torch.as_tensor((rank[:, None] + rank) % n, device="cuda")
    pe = torch.arange(n, device="cuda")[:, None]
    xv = x.view(n, n, L // n)
    if not torch.equal(xv[pe, blk].reshape(n, L), got):
        raise AssertionError("advanced indexing != dma_copy")
    del got
    segs = -(-(L // n * 4) // pc.SEG_BYTES)
    descs = plan.on(x.device)
    row("dma_copy",
        err, time_ms(lambda: lib.repro_dma_copy(
            x.data_ptr(), y.data_ptr(), descs.data_ptr(), len(plan), segs, 4,
            L, L, stream), iters=20, warmup=3),
        time_ms(lambda: ref.dma_copy_ref(x, y, plan.descs), iters=10,
                warmup=2),
        time_ms(lambda: xv[pe, blk], iters=20, warmup=3),
        2 * nbytes, "16 x 64 MiB f32, 256 descriptors of 4 MiB")

    clib = rc._library()
    b = torch.randn((n, L), generator=gen, device="cuda")
    got = rc.reduce_combine([x, b], "sum")
    err = float((got - ref.reduce_combine_ref([x, b], "sum")).abs().max())
    if not torch.equal(torch.add(x, b), got):
        raise AssertionError("torch.add != reduce_combine")
    del got
    ptrs = (ctypes.c_void_p * 2)(x.data_ptr(), b.data_ptr())
    lds = (ctypes.c_int64 * 2)(L, L)
    row("reduce_combine",
        err, time_ms(lambda: clib.repro_reduce_combine(
            ptrs, lds, 2, y.data_ptr(), n, L, 0, 0, stream), iters=20,
            warmup=3),
        time_ms(lambda: ref.reduce_combine_ref([x, b], "sum"), iters=10,
                warmup=2),
        time_ms(lambda: torch.add(x, b, out=y), iters=20, warmup=3),
        3 * nbytes, "two 16 x 64 MiB f32 buffers, sum")
    del x, y, b
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: the OpenSHMEM runtime on the card
# ---------------------------------------------------------------------------

def f32_sum_ok(np, got, x64) -> float:
    """Largest |got - exact| over its bound (n-1) * 2^-24 * sum|x|, the
    worst case of n f32 additions in any order; <= 1 passes."""
    exact = x64.sum(0)
    bound = (x64.shape[0] - 1) * 2.0 ** -24 * np.abs(x64).sum(0) + 1e-30
    return float((np.abs(got.astype(np.float64) - exact) / bound).max())


def runtime(torch, np) -> dict:
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import collectives as coll
    from repro_torch.core import sim_ctx
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    n, topo = paper.N_PES, paper.TOPOLOGY
    rng = np.random.default_rng(0)
    ring = [(i, (i + 1) % n) for i in range(n)]
    mirror = [(i, n - 1 - i) for i in range(n)]
    want = {"put_copy": 0, "dma_copy": 0, "reduce_combine": 0}

    def expect(ctx, stages_or_patterns, dma=0, combines=0):
        """Launches one op must make: a put per ppermute (plus, under
        NoC waves, a wave fold per multi-wave pattern), a DMA per block
        gather, a combine per reduction stage."""
        pats = [getattr(p, "pattern", p) for p in stages_or_patterns]
        want["put_copy"] += len(pats)
        want["dma_copy"] += dma
        want["reduce_combine"] += combines
        if getattr(ctx.net, "topo", None) is not None:
            want["reduce_combine"] += sum(len(p.link_waves(topo)) > 1
                                          for p in pats)

    def exact(got, oracle, what):
        g = got.cpu().numpy()
        if g.shape != oracle.shape or not np.array_equal(g, oracle):
            raise AssertionError(f"{what}: differs from numpy")

    def close(got, x64, what):
        ratio = f32_sum_ok(np, got.cpu().numpy(), x64)
        if not ratio <= 1.0:
            raise AssertionError(f"{what}: f32 sum off by {ratio:.3g}x its "
                                 f"bound")
        return ratio

    def with_rows(x, pairs):
        out = x.copy()
        for s, d in pairs:
            out[d] = x[s]
        return out

    pc.launches = pc.dma_launches = rc.launches = 0     # phase 5 starts
    t0 = time.perf_counter()
    worst = 0.0
    for noc in (False, True):
        ctx = sim_ctx(n, topo, noc=noc, device="cuda")
        for size in paper.MSG_SIZES:
            e = size // 4
            xi_h = rng.integers(-1000, 1000, (n, e), dtype=np.int32)
            xf_h = rng.standard_normal((n, e), dtype=np.float32)
            xi, xf = torch.from_numpy(xi_h).cuda(), \
                torch.from_numpy(xf_h).cuda()
            tag = f"noc={noc} {size} B"
            exact(ctx.put(xi, ring), with_rows(xi_h, ring), f"put {tag}")
            expect(ctx, [ctx.compile(ring)])
            exact(ctx.get(xf, ring), np.roll(xf_h, -1, 0), f"get {tag}")
            expect(ctx, [ctx._owner_push(ring)])
            pats = [[(0, 5)], ring, mirror]
            for p in pats:
                ctx.put_nbi(xi, p)
            for p, v in zip(pats, ctx.quiet()):
                exact(v, with_rows(xi_h, p), f"put_nbi+quiet {tag}")
            expect(ctx, [ctx.compile(p) for p in pats])
            f1 = ctx.put_nbi(xi, [(0, 3)])
            f2 = ctx.put_nbi(2 * xi, [(1, 3)])
            if len(ctx.fence()) != 2 or f1.done or ctx.pending_count != 2:
                raise AssertionError(f"fence completed ops {tag}")
            ctx.quiet()
            exact(f2.value, with_rows(2 * xi_h, [(1, 3)]), f"fence {tag}")
            expect(ctx, [ctx.compile([(0, 3)]), ctx.compile([(1, 3)])])
            tok = ctx.barrier_all(torch.ones(n, dtype=torch.int32,
                                             device="cuda"))
            exact(tok, np.full(n, n, np.int32), f"barrier_all {tag}")
            expect(ctx, coll.barrier_schedule(n).stages)
            exact(ctx.broadcast(xf, 5), np.tile(xf_h[5], (n, 1)),
                  f"broadcast {tag}")
            expect(ctx, coll.broadcast_schedule(n, 0.0, 5).stages)
            allv = np.tile(xi_h.reshape(-1), (n, 1))
            exact(ctx.fcollect(xi), allv, f"fcollect {tag}")
            expect(ctx, coll.fcollect_schedule(n, 0.0, "rd").stages, dma=1)
            exact(ctx.collect(xi), allv, f"collect {tag}")
            expect(ctx, coll.fcollect_schedule(n, 0.0, "ring").stages, dma=1)
            isum = np.tile(xi_h.sum(0, dtype=np.int64).astype(np.int32),
                           (n, 1))
            for algo, dma, comb in (("rd", 0, 4), ("ring", 2, n - 1)):
                sched = coll.allreduce_schedule(n, 0.0, algo).stages
                exact(ctx.to_all(xi, "sum", algorithm=algo), isum,
                      f"to_all {algo} i32 {tag}")
                expect(ctx, sched, dma=dma, combines=comb)
                got = ctx.to_all(xf, "sum", algorithm=algo)
                worst = max(worst, close(got, xf_h.astype(np.float64),
                                         f"to_all {algo} f32 {tag}"))
                expect(ctx, sched, dma=dma, combines=comb)
            own, info = ctx.reduce_scatter(xi)
            exact(coll.allgather_unpad(ctx.net, own, info), isum,
                  f"reduce_scatter+allgather {tag}")
            expect(ctx, coll.reduce_scatter_schedule(n).stages, dma=1,
                   combines=n - 1)
            expect(ctx, coll.allgather_schedule(n).stages, dma=1)
            blk = max(1, e // n)
            a_h = rng.integers(-99, 99, (n, n * blk), dtype=np.int32)
            exact(ctx.alltoall(torch.from_numpy(a_h).cuda()),
                  a_h.reshape(n, n, blk).transpose(1, 0, 2)
                  .reshape(n, n * blk), f"alltoall {tag}")
            expect(ctx, coll.alltoall_schedule(n).stages, dma=2)
    torch.cuda.synchronize()
    log(f"  paper sweep: {len(paper.MSG_SIZES)} sizes "
        f"({paper.MSG_SIZES[0]} B .. {paper.MSG_SIZES[-1]} B per PE) x 2 "
        f"nets x 14 ops checked against numpy in "
        f"{time.perf_counter() - t0:.1f} s; worst f32 sum error "
        f"{worst:.3f} of its bound")

    # the trainer's 64 MiB-per-PE gradient bucket on 16 PEs
    ctx = sim_ctx(n, topo, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    xf = torch.randn((n, BUCKET_ELEMS), generator=gen, device="cuda")
    xi = torch.randint(-1000, 1000, (n, BUCKET_ELEMS), generator=gen,
                       device="cuda", dtype=torch.int32)
    xf64 = xf.cpu().numpy().astype(np.float64)
    isum = xi.cpu().numpy().sum(0, dtype=np.int64).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.setdefault(label, []).append(time.perf_counter() - t)
        if not torch.equal(out, out[:1].expand_as(out)):
            raise AssertionError(f"{label}: PEs disagree")
        return out[0].cpu().numpy()

    rs_ag = lambda v: coll.allgather_unpad(  # noqa: E731
        ctx.net, *ctx.reduce_scatter(v))
    runs = [(algo, (lambda v, a=algo: ctx.to_all(v, "sum", algorithm=a)),
             coll.allreduce_schedule(n, 0.0, algo).stages, dma, comb)
            for algo, dma, comb in (("rd", 0, 4), ("ring", 2, n - 1))]
    runs.append(("rs+ag", rs_ag, coll.reduce_scatter_schedule(n).stages
                 + coll.allgather_schedule(n).stages, 2, n - 1))
    for label, fn, stages, dma, comb in runs:
        for _ in range(2):
            got = timed(f"{label} i32", lambda: fn(xi))
            if not np.array_equal(got, isum):
                raise AssertionError(f"bucket {label} i32 differs")
            expect(ctx, stages, dma=dma, combines=comb)
            got = timed(f"{label} f32", lambda: fn(xf))
            ratio = f32_sum_ok(np, got, xf64)
            if not ratio <= 1.0:
                raise AssertionError(f"bucket {label} f32 off by {ratio}x")
            expect(ctx, stages, dma=dma, combines=comb)
    peak = torch.cuda.max_memory_allocated()
    got = {"put_copy": pc.launches, "dma_copy": pc.dma_launches,
           "reduce_combine": rc.launches}                # phase 5 ends
    for label, ws in walls.items():
        log(f"  bucket 16 x 64 MiB {label}: wall "
            + ", ".join(f"{w * 1e3:.3f}" for w in ws) + " ms")
    log(f"  bucket peak device memory {peak / 2**30:.3f} GiB (inputs "
        f"2 x 1 GiB); launches {got}, implied by the schedules {want}")
    for name in want:
        if got[name] != want[name] or got[name] < 1:
            raise AssertionError(f"{name}: {got[name]} launches, the "
                                 f"schedules imply {want[name]}")
    small_op_walls(torch, ctx, n, ring)
    return got


def small_op_walls(torch, ctx, n, ring) -> None:
    """Wall time of single calls at the paper's smallest and largest
    message sizes (synchronised host clock, median of 21): what one
    launch-bound collective costs on the card's host."""
    import statistics
    for size in (8, 16384):
        x = torch.ones((n, size // 4), dtype=torch.int32, device="cuda")
        ops = {"put": lambda: ctx.put(x, ring),
               "barrier_all": lambda: ctx.barrier_all(),
               "to_all rd": lambda: ctx.to_all(x, "sum", algorithm="rd"),
               "to_all ring": lambda: ctx.to_all(x, "sum",
                                                 algorithm="ring"),
               "fcollect": lambda: ctx.fcollect(x)}
        walls = {}
        for name, fn in ops.items():
            ts = []
            for _ in range(21):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            walls[name] = statistics.median(ts) * 1e3
        log(f"  {size} B per PE, median wall ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()))


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
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        libs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    log(f"  built {KERNELS} in {time.perf_counter() - t:.1f} s")
    for name, path in libs.items():
        report = path.with_suffix(".log").read_text()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", report)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", report))
        log(f"    {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, {spills} bytes of spill (nvcc -Xptxas -v)")

    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_attention(torch, ops, ref, gen)
    timing = time_attention(torch, fa, ref, gen)

    log(f"== phase 3: serve {serving.CONFIG.name} at full width")
    eng, prompts, launches = serve(torch, np, fa, serving, ServeEngine)
    prefill_logits_check(torch, np, ref, layers, eng, prompts, serving,
                         ServeEngine)

    log("== phase 4: runtime kernels against their plain versions")
    check_runtime_kernels(torch, gen)
    rt_timing = time_runtime_kernels(torch, gen)

    log("== phase 5: the OpenSHMEM runtime on 16 PEs")
    rt_launches = runtime(torch, np)

    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:79",
        launches=launches["flash_attention"],
        max_abs_err=timing["max_abs_err"], ms=timing["ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"])]
    for name, source, replaces in RUNTIME_KERNELS:
        t = rt_timing[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=rt_launches[name], max_abs_err=t["max_abs_err"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
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

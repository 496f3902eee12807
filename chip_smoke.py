#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:
  1. setup — torch, CUDA and nvcc versions, the card's name and power
     limit, and the build of every kernel from the sources in this
     checkout (one nvcc per source, all started together); per kernel
     of kernels 4 and 6 its registers and spill, and their SASS must
     hold HGMMA (wgmma) and UTMALDG (TMA loads);
  2. kernels — kernel 4 against its plain PyTorch version on the card,
     at the serving and training paths' shapes, over a grid of edge
     cases, at the zoo's head dims with their heads (hubert 80, phi-3-
     vision 96, danube 120, gemma2 256 with softcap 50, MLA 192 against
     a v head dim of 128) at 200 and 4096 tokens, and on rows that keep
     no key (lk_valid), with the tolerance stated per dtype (f32 cases
     against the plain version evaluated in f64); bf16 at head dims that
     are multiples of 8 must take the tensor cores; then timed at the
     serving and training shapes beside its plain version and one
     PyTorch library call (a yardstick the port never calls);
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
     byte widths, unaligned rows), f32/i32/bf16/f64 and 64 MiB buffers;
     the combine over both of its paths (16-byte vectors with a scalar
     tail; scalar for a base or row stride off 16 bytes): contiguous,
     ragged columns, the ring's strided blocks, a base one element off, an
     odd row stride, x f32/bf16/f16/i32/i8/f64/i64 x sum/prod/max/min
     (NaN in the floats) x k 2, 3, 4, 17, 33; then timed at the
     runtime's real size beside the plain version and one PyTorch call
     (the combine in alternating pairs with torch.add);
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
     few single calls at 8 B and 16 KB per PE;
  6. train — (a) the combine + AdamW kernel (kernel 5) bit for bit
     against its plain version over k, lengths, offsets, masks, output
     dtypes and extreme gradients, then timed at the 16-PE bucket and at
     the full-width step; (b) fused_rs_adam on 16 PEs at the 64 MiB-per-PE
     bucket, bit for bit against reduce_scatter + allgather_unpad + the
     plain AdamW; (c) qwen2-0.5b trained at full width, N steps through
     the launcher (default sync) and N through the fused sync, losses
     finite and falling, launch counts equal to their formulas; (d) one
     gradient tree through apply_updates and through fused_adam_sync, bit
     for bit; (e) the loss and gradients through the flash kernel against
     those through the plain attention, in f32 and bf16;
  7. serve mamba2-2.7b — (a) the SSD scan kernel (kernel 7,
     csrc/ssd_scan.cu) through ops.ssd against the plain chunked version
     over tests/test_kernels.py's shapes, h0, ragged L, and the model's
     head shape (H 80, P 64, N 128, chunk 128) contiguous and strided,
     f32 and bf16, each of its three phases (the cumsums, the chunk
     states, the entering and final states, y) against its plain form on
     the kernel's own inputs to it, and the sequential-scan oracle
     against the chunked version; (b) kernel 7 timed at the prefill's
     shape beside its plain version, its three CUDA kernels by the
     profiler; (c) build_prefill on mamba2-2.7b at full width (64 layers,
     d 2560, vocab 50280, seeded random weights, bf16 compute) over one
     32768-token prompt: exactly 64 kernel-7 launches (counts set to 0
     just before, read just after) and finite logits; the same prefill
     through the plain version with kernel 7 held to it in each layer on
     that layer's inputs; the prefill in f32 compute through both, logits
     within 1e-2 of the largest;
     (d) `launch.serve --arch mamba2-2.7b` through main(): the dense-cache
     decode loop at batch 4, prompt 32, 16 tokens, (4, 16) tokens, and
     the loop's logits at the last prompt position against
     build_prefill's on the same prompts;
  8. ring attention — (a) the ring-partials kernel (kernel 6,
     csrc/ring_attention.cu) against its plain version over D 16-256, f32
     and bf16, causal or not, window, softcap, GQA groups 1 and 7, ragged
     Lq/Lk, -1 key slots, wholly and partly masked blocks, rows that keep
     their first key after masked tiles, padded shards, 1, 4 and 16
     PEs (m, l within 1e-5 x sqrt(D/16), acc within 2e-5 x max(1,
     l |v|max), finalize within 2e-5 x sqrt(D/16), wholly masked rows at
     m = -1e30 and the plain l exactly); (b) kernel 6 timed at the ring
     step's shape (16 PEs, Hq 14, Hkv 2, 2048 x 2048, D 64, bf16) on a
     diagonal, a wholly kept and a wholly masked block, each beside its
     plain version, SDPA with the block mask and its own bound; (c) qwen2-0.5b's
     layer-0 q, k, v over a 32768-token prompt, sharded over 16 PEs of
     the 4x4 mesh, through fusion.ring_attention on the plain and the NoC
     SIM: exactly 16 kernel-6 launches and the puts the code implies
     (counts set to 0 just before, read just after), the output within
     max(2e-5, 1 bf16 step) of kernel 4 over the gathered sequence and of
     the ring through the plain partials, then with a window of 4096 and
     a softcap of 50; the ring and mono walls, the peak memory, kernel 4
     at the gathered shape beside scaled_dot_product_attention (a
     yardstick), and choose_attention's pick at the measured per-block
     time;
  9. serve zamba2-1.2b (the hybrid family: 38 Mamba2 layers at d 2048
     and one shared attention + MLP block after every 6 of them, 7
     applications) — (a) kernel 7 at its head shape (H 64, P 64, N 64,
     chunk 128) contiguous and strided, f32 and bf16, each phase against
     its plain form as in 7a, and kernel 4 at B 1, Hq = Hkv = 32, D 64,
     bf16, causal over 4096 tokens against the plain version and against
     the blockwise plain version 9c uses; (b) kernel 7 and kernel 4 timed
     at the 32768-token prefill's shapes, kernel 4 beside the blockwise
     plain version and scaled_dot_product_attention; (c) build_prefill
     over one 32768-token prompt at full width: exactly 38 kernel-7 and 7
     kernel-4 launches (counts set to 0 just before, read just after),
     finite logits, wall, tok/s, peak; the same prefill through the plain
     versions with kernel 7 held to them in every layer and kernel 4 on
     every query row of its 7 calls (the plain attention built 1024 rows
     at a time from ref.ring_partials_ref); the prefill in f32 compute
     through both, logits within 1e-2 of the largest; (d) `launch.serve
     --arch zamba2-1.2b` through main(): (4, 16) tokens, the loop's logits
     at the last prompt position against build_prefill's, and in f32
     compute the same decode within 1e-2 of the prefill's; (e) one
     build_decode_step against caches of 32768 slots at batch 4 filled
     from a seeded generator, at position 32767: finite logits, each
     shared cache changed only at slot 32767, the wall of a step and the
     peak memory;
 10. serve the rest of the dense family at full width (every earlier
     phase's models and engines freed first; the memory still allocated
     is printed) — (a) kernel 4 at each kind of call of the three
     prefills (gemma2-9b's local and global layers: Hq 16 over Hkv 8, D
     256, softcap 50, the local ones windowed at 4096; h2o-danube-3-4b:
     Hq 32 over 8, D 120, window 4096; internlm2-20b: Hq 48 over 8, D
     128), bf16 and f32 over 4096 tokens (windows cut to 1024 so that
     they bite) against the plain version and against the blockwise
     plain version, then timed over 32768 tokens beside that version, its
     bound and scaled_dot_product_attention (causal without the softcap;
     windowed through an additive mask over all L^2 pairs); (b)
     build_prefill of gemma2-9b (42 layers, d 3584, vocab 256000, f32
     weights) over one 32768-token prompt: exactly 42 kernel-4 launches,
     21 with window 4096 (counts set to 0 just before, read just after),
     finite logits, wall, tok/s, peak; the same prefill with kernel 4
     held to the blockwise plain version on every query row of all 42
     calls, each checked as it happens; the f32 prefill over its first
     8192 tokens through both, logits within 1e-2 of the largest;
     `launch.serve --arch gemma2-9b` through main(): (4, 16) tokens from
     the paged engine sized max(--cache-len, prompt + tokens), and one
     request's prefill logits through the kernel against the plain
     version (phase 3's rule); (c) one gemma2 build_decode_step against
     caches of 32768 slots at batch 2 (21 global caches, 21 local rings
     of 4096) filled from seeded generators at position 32767: finite
     logits, each global cache changed only at slot 32767 and each ring
     only at 4095, checked against each cache regenerated from its seed
     one at a time, the wall of a step and the peak; (d) the same
     prefill and launcher for h2o-danube-3-4b (24 launches, all held)
     and internlm2-20b (bf16 weights; 48 launches, all held);
 11. serve the moe family at full width (phase 10's models freed first)
     — (a) kernel 4 at granite-moe-3b-a800m's calls (Hq 24 over Hkv 8, D
     64) and deepseek-v3's MLA (Hq = Hkv = 128, D 192 against a v head
     dim of 128, scale 1/sqrt(192)), bf16 and f32 over 4096 tokens
     against the plain and the blockwise plain versions, then timed over
     32768 tokens beside that version, its bound and scaled_dot_product_
     attention (for MLA the first fused backend that takes Dv apart from
     D, named); (b) build_prefill of granite (32 layers of GQA attention
     and 40 routed experts, top-8, f32 weights) over one 32768-token
     prompt: exactly 32 kernel-4 launches (counts set to 0 just before,
     read just after), finite logits, walls, tok/s, peak; the same
     prefill with every call held to the blockwise plain version; the
     f32 prefill over its first 8192 tokens through kernel 4 and through
     that version with each layer's routes (top-k experts, kept flags)
     recorded: where every layer's routes agree, logits within 1e-2 of
     the largest, else each layer's differing picks printed, the layer
     outputs before the first differing layer within 1e-2 of their
     largest and that layer's differing picks under 0.1%; `launch.serve
     --arch granite-moe-3b-a800m` through main(): the dense-cache decode
     loop to (4, 16) tokens; (c) the same for deepseek-v3 cut to
     SERVE_RUN's 4 layers (3 dense MLA layers, 1 MoE layer of 256
     routed experts and a shared one; bf16 weights; exactly 4
     launches), its decode loop through launch.serve's `_decode_loop`,
     and one decode step against 32768-slot MLA caches at batch 4 that
     must change every layer's c_kv and k_rope at slot 32767 in every row
     and nothing else;
 12. serve hubert-xlarge, the encoder, at full width (phase 11's models
     freed first) — (a) kernel 4 at its calls (Hq = Hkv = 16, D 80,
     non-causal: no tile is skipped) bf16 and f32 over 4096 tokens
     against the plain and the blockwise plain versions; (b) timed over
     32768 tokens beside that version, its bound and scaled_dot_product_
     attention without a mask; (c) build_prefill (48 layers, d 1280, f32
     weights) over SERVE_RUN's frames (1, 32768, 1280) from input_specs:
     exactly 48 non-causal kernel-4 launches (counts set to 0 just
     before, read just after), finite logits, walls, frames/s, peak;
     every call held to the blockwise plain version; forward in f32
     compute over the first 8192 frames through kernel 4 and that
     version: the hidden state at every position and the logits within
     1e-2 of their largest; (d) `launch.serve --arch hubert-xlarge`
     raises the reference's SystemExit with no launch and no memory;
 13. serve phi-3-vision-4.2b at full width — (a), (b) kernel 4 at its
     calls (Hq = Hkv = 32, D 96, causal) as 12a-b, SDPA causal; (c)
     build_prefill (32 layers, d 3072, f32 weights) over a 32768-token
     prompt with frontend embeds (1, 576, 3072) from input_specs: exactly
     32 launches, each held; the f32 gate over 8192 tokens with the
     embeds (logits within 1e-2), whose logits without the embeds must
     differ by more than that; (d) `launch.serve --arch phi-3-vision-
     4.2b` through the paged engine at the reference's defaults, one
     request's prefill logits against the plain version; (e) one decode
     step against 32768-slot dense caches at batch 2 (32 layers of k
     and v, 24 GiB) that must change slot 32767 of every row of every
     cache leaf and nothing else;
 14. the measurement services on the card — (a) a level-2 Profiler on
     sim_ctx(16) over the 4x4 mesh: phase 5's collectives at 8 B per PE
     and the bucket's (to_all rd, ring, reduce_scatter) at 1 GiB, one
     sample per call whose fields equal those of the same call on the
     CPU SIM, kernels 1-3's launches equal with no profiler, pcontrol(0)
     and pcontrol(2), and at 1 GiB each sample's wall_s within 20% of a
     host-clock wall ended by a device wait; (b) Tuner.tune over the
     train launcher's autotune grid (allreduce and fcollect x 4 KiB,
     64 KiB, 1 MiB x chunks 1, 4; iters 3, warmup 1): points and
     variants as `_variants` gives them, launches (warmup + iters) x each
     variant's per-call count plus refit_link's, each best the argmin of
     its means, the tuned allreduce within 1e-4 of the untuned, and the
     fitted alpha_s, bw_Bps and contention printed as the card's; (c)
     choose_attention at phase 8's ring shape: untuned, the cost model's
     pick; with phase 8's measured walls in a TuningDB, the faster one;
     (d) qwen2-0.5b's engine on phase 3's traffic with a LEVEL_FULL
     Tracer and ServeMetrics: phase 3's tokens, valid documents, exactly
     8 submitted, 8 completed, 256 tokens, 0 pages live, TTFT and
     per-token p50 beside an untraced run's and phase 3's; (e)
     `launch.serve --arch
     qwen2-0.5b --trace-out --metrics-out` writes valid documents.

The last lines are one JSON object per kernel run ({"kernels": [...]}:
the seven kernels, then one flash_attention row per prefill shape of
phases 10-13, with a "shape" key),
the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
KERNELS = ["flash_attention", "put_copy", "reduce_combine",
           "fused_update", "ssd_scan", "ring_attention"]

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


def kernel_label(mangled: str) -> str:
    """A short name for a kernel's mangled symbol in nvcc's report: the
    function's name and its template arguments (dtype, int parameters)."""
    m = re.search(r"(flash_fwd_tc|flash_fwd_cc|ring_partials_tc|"
                  r"ring_partials_cc|ring_prep|[a-z_]*(?:kernel|partials|fwd))"
                  r"(?=[IE])(I(?:13__nv_bfloat16|f|Li\d+E)+E)?", mangled)
    if not m:
        return mangled[-48:]
    args = [{"f": "f32"}.get(a.group(0), a.group(1) or "bf16")
            for a in re.finditer(r"13__nv_bfloat16|Li(\d+)E|f",
                                 m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


# the opcodes that show kernels 4 and 6 on Hopper's tensor cores (HGMMA:
# wgmma) fed by TMA (UTMALDG), and HMMA (mma.sync) for contrast
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts(path: Path) -> dict | None:
    """{opcode: count} in a library's SASS by cuobjdump, or None when the
    toolkit has no cuobjdump or it shows no SASS for the library."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).with_name("cuobjdump"))
    if not Path(tool).is_file():
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300).stdout
    if "Function :" not in sass:
        return None
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


def report_builds(libs: dict) -> None:
    """Per library, nvcc's resource report (`-Xptxas -v`, kept beside it):
    kernels, registers, spill, and which kernels spill; per kernel of the
    SSD scan, its registers; per kernel of kernels 4 and 6, registers and
    spill, and their SASS's tensor-core and TMA opcodes (a kernel 4 or 6
    without HGMMA fails the run)."""
    for name, path in libs.items():
        report = path.with_suffix(".log").read_text()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", report)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", report))
        log(f"    {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, {spills} bytes of spill (nvcc -Xptxas -v)")
        entries = re.findall(r"Compiling entry function '([^']+)'.*?(\d+)"
                             r" bytes spill stores", report, re.S)
        spilling = [e for e, sp in entries if int(sp)]
        if spilling:
            log(f"      {len(spilling)} of them spill: "
                + ", ".join(kernel_label(e) for e in spilling[:6]))
        if name in ("flash_attention", "ring_attention"):
            log("      " + ", ".join(
                f"{kernel_label(e)} {r} regs" + (f" {sp} B spill"
                                                 if int(sp) else "")
                for e, sp, r in re.findall(
                    r"Compiling entry function '([^']+)'.*?(\d+) bytes "
                    r"spill stores.*?Used (\d+) registers", report, re.S)))
            ops = sass_counts(path)
            log(f"      SASS: {ops if ops else 'not readable (no cuobjdump)'}")
            if ops is not None and not (ops["HGMMA"] and ops["UTMALDG"]):
                raise AssertionError(f"{name}: no HGMMA or UTMALDG in its "
                                     f"SASS ({ops})")
        if name == "ssd_scan":
            dtypes = {"If": " f32", "I13__nv_bfloat16": " bf16"}
            log("      registers: " + ", ".join(
                f"{k}{dtypes.get(t, '')} {r}" for k, t, r in re.findall(
                    r"Compiling entry function '[^']*?(chunk_state|"
                    r"state_pass|chunk_output)_kernel(If|I13__nv_bfloat16)?"
                    r"[^']*'.*?Used (\d+) registers", report, re.S)))


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


def attention_inputs(torch, gen, b, hq, hkv, lq, lk, d, dt, dv=None):
    def rnd(scale, *shape):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dt)
    return (rnd(QK_SCALE, b, hq, lq, d), rnd(QK_SCALE, b, hkv, lk, d),
            rnd(1.0, b, hkv, lk, dv or d))


# fault C1: the zoo's full-width head dims with their heads
# (src/repro/configs/): (label, Hkv, group, D, Dv, kwargs).  Their windows
# are 4096 wide; a window is cut to 33 at the short length and to 1024 at
# 4096 tokens, so that it bites at both.
C1_MODELS = [
    ("hubert", 16, 1, 80, 80, dict(causal=False)),
    ("phi3v", 32, 1, 96, 96, dict(causal=True)),
    ("danube", 8, 4, 120, 120, dict(causal=True, window=4096)),
    ("gemma2", 8, 2, 256, 256, dict(causal=True, window=4096, softcap=50.0)),
    ("mla", 128, 1, 192, 128, dict(causal=True)),
]


def attention_cases():
    """(label, B, Hkv, group, Lq, Lk, D, dtype name, kwargs, Dv)."""
    cases = [("slice", 1, 2, 7, 128, 256, 64, "bfloat16", dict(causal=True)),
             ("slice_ragged", 1, 2, 7, 100, 100, 64, "bfloat16",
              dict(causal=True)),
             ("slice_noncausal", 1, 2, 7, 128, 256, 64, "bfloat16",
              dict(causal=False)),
             ("slice_f32", 1, 2, 7, 128, 256, 64, "float32",
              dict(causal=True)),
             # the training step's shape (one microbatch of TRAIN_RUN)
             ("train", 2, 2, 7, 128, 128, 64, "bfloat16", dict(causal=True)),
             ("train_f32", 2, 2, 7, 128, 128, 64, "float32",
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
    cases = [c + (c[6],) for c in cases]
    for label, hkv, group, d, dv, kw in C1_MODELS:
        for length, window in ((200, 33), (4096, 1024)):
            opts = dict(kw, window=window) if "window" in kw else kw
            for dtype in ("float32", "bfloat16"):
                cases.append((f"{label}{length}", 1, hkv, group, length,
                              length, d, dtype, opts, dv))
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


def ulp(torch, x):
    """The spacing of x's dtype at each element's magnitude, in f32."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.full_like(x, torch.finfo(x.dtype).eps,
                                       dtype=torch.float32), e - 1)


def plain_attention(torch, ref, q, k, v, exact=True, **kw):
    """The plain version on these inputs, a few KV heads at a time (its
    logits at 128 heads x 4096^2 would not fit at once).  For f32 inputs
    (unless exact=False) it runs in f64 and is rounded to f32 at the end:
    its own f32 evaluation errs by 3.0e-5 to 3.4e-5 at D 192 and 256 over
    4096 tokens (cuBLAS's f32 GEMM over D terms: check_attention prints
    it), at and above the 3e-5 tolerance, while kernel 4 stays within
    ~1e-5 of the f64 value.  So an f32 case holds the kernel to the
    function's exact value; the limit is unchanged."""
    hkv = k.shape[1]
    group = q.shape[1] // hkv
    step = max(1, 16 // group)
    up = (lambda x: x.double()) if exact and q.dtype == torch.float32 \
        else (lambda x: x)
    parts = [ref.attention_ref(up(q[:, h * group:(h + step) * group]),
                               up(k[:, h:h + step]), up(v[:, h:h + step]),
                               **kw)
             for h in range(0, hkv, step)]
    return torch.cat(parts, dim=1).to(q.dtype)


def attention_over(torch, out, want, dt) -> tuple[float, float]:
    """(max|err|, worst err/limit) of an output against its plain version:
    an output rounded to its dtype cannot be held closer than one step of
    that dtype at its own magnitude, so the limit of an element is the
    larger of the dtype's tolerance and that step (for bf16 they differ
    only where |want| >= 4, where the step is 2^-5 = 0.03125)."""
    diff = (out.float() - want.float()).abs()
    limit = torch.maximum(torch.full_like(diff, TOL[str(dt)]),
                          ulp(torch, want))
    return diff.max().item(), (diff / limit).max().item()


def check_attention(torch, ops, ref, fa, gen) -> dict:
    worst = {}
    for label, b, hkv, group, lq, lk, d, dtype, kw, dv in attention_cases():
        dt = getattr(torch, dtype)
        q, k, v = attention_inputs(torch, gen, b, hkv * group, hkv, lq, lk,
                                   d, dt, dv)
        out = ops.attention(q, k, v, **kw)
        want = plain_attention(torch, ref, q, k, v, **kw)
        torch.cuda.synchronize()
        if out.shape != want.shape or out.dtype != want.dtype:
            raise AssertionError(f"{label}: {out.shape}/{out.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label} {kw}: non-finite output")
        err, over = attention_over(torch, out, want, dt)
        tol = TOL[str(dt)]
        typical = want.float().abs().mean().item()
        route = "tensor cores" if fa.tensor_core_route(q, k, v) \
            else "CUDA cores"
        oracle = ""
        if dtype == "float32":
            plain32 = plain_attention(torch, ref, q, k, v, exact=False, **kw)
            oracle = (f"; the plain version's own f32 max|err| "
                      f"{(plain32 - want).abs().max().item():.3e}")
            del plain32
        log(f"  attention {label:16s} {dtype:8s} B{b} Hq{hkv * group} "
            f"Hkv{hkv} Lq{lq} Lk{lk} D{d} Dv{dv} {kw} ({route}): max|err| "
            f"{err:.3e} (tol {tol:g} or 1 ulp, worst err/limit {over:.3f}, "
            f"mean|out| {typical:.3f}{oracle})")
        if dtype == "bfloat16" and d % 8 == 0 and dv % 8 == 0 \
                and route != "tensor cores":
            raise AssertionError(f"{label}: bf16 at D{d}/Dv{dv} did not "
                                 f"take the tensor cores")
        if not over <= 1.0:
            raise AssertionError(f"{label} {dtype} {kw}: max|err| {err}, "
                                 f"err/limit {over} > 1")
        if not typical > 10 * tol:
            raise AssertionError(f"{label} {dtype}: mean|out| {typical} is "
                                 f"not far above the tolerance {tol}")
        if "softcap" in kw:
            blind = plain_attention(torch, ref, q, k, v,
                                    **{**kw, "softcap": None})
            gap = (blind.float() - want.float()).abs().max().item()
            if not gap > 2 * tol:
                raise AssertionError(f"{label} {dtype} {kw}: dropping the "
                                     f"softcap moves the output by {gap}, "
                                     f"not more than twice the tolerance")
        worst[label + dtype] = err
    return worst


def check_attention_edges(torch, fa, ref, gen) -> None:
    """Kernel 4's wrapper with lk_valid against the plain version: rows
    that keep no key (non-causal with lk_valid 0; a window above a short
    lk_valid), lk_valid below one key tile, and a window that skips the
    leading key tiles of later query tiles, at the C1 head dims, f32 and
    bf16.  The limits are check_attention's; a row that keeps nothing is
    the mean of v over the Lk slots, so these outputs are small and no
    mean|out| floor applies."""
    cases = [("none_noncausal", 80, 80, 128, 128, 0, dict(causal=False)),
             ("none_window", 120, 120, 128, 256, 3,
              dict(causal=True, window=8)),
             ("below_tile", 256, 256, 128, 256, 40, dict(causal=False)),
             ("window_skips", 96, 96, 512, 512, 512,
              dict(causal=True, window=100)),
             ("mla_window", 192, 128, 256, 256, 200,
              dict(causal=True, window=70, softcap=50.0))]
    dead_rows = 0
    for label, d, dv, lq, lk, lk_valid, kw in cases:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v = attention_inputs(torch, gen, 1, 4, 2, lq, lk, d, dt,
                                       dv)
            out = fa.flash_attention(q, k, v, lk_valid=lk_valid, **kw)
            want = plain_attention(torch, ref, q, k, v, lk_valid=lk_valid,
                                   **kw)
            torch.cuda.synchronize()
            err, over = attention_over(torch, out, want, dt)
            qp = torch.arange(lq, device="cuda")[:, None]
            kp = torch.arange(lk, device="cuda")[None, :]
            keep = (kp < lk_valid).expand(lq, lk)
            if kw.get("causal"):
                keep = keep & (kp <= qp)
            if kw.get("window"):
                keep = keep & (kp > qp - kw["window"])
            dead = int((~keep.any(1)).sum())
            dead_rows += dead
            log(f"  attention edge {label:14s} {dtype:8s} Lq{lq} Lk{lk} "
                f"lk_valid {lk_valid} D{d} Dv{dv} {kw}: rows keeping no key "
                f"{dead} of {lq}; max|err| {err:.3e}, worst err/limit "
                f"{over:.3f}")
            if not (over <= 1.0 and torch.isfinite(out).all()):
                raise AssertionError(f"attention edge {label} {dtype}: "
                                     f"err/limit {over}")
    if not dead_rows:
        raise AssertionError("attention edges: no row kept nothing")


ATTN_TIMED = {"serving": (1, 14, 2, 128, 256, 64),   # the qwen2 prefill
              "training": (2, 14, 2, 128, 128, 64)}  # a TRAIN_RUN microbatch


def time_attention(torch, fa, ref, gen, card) -> dict:
    """Times at the serving prefill's and the training step's shapes
    (ATTN_TIMED): the kernel alone (its C entry called back to back), the
    wrapper, the plain version, and scaled_dot_product_attention as the
    library yardstick.  Returns the serving shape's, with the training
    shape's under "training"."""
    import torch.nn.functional as F
    got = {}
    for shape, (b, hq, hkv, lq, lk, d) in ATTN_TIMED.items():
        got[shape] = time_attention_at(torch, F, fa, ref, gen, card, b, hq,
                                       hkv, lq, lk, d)
    return dict(got["serving"], training=got["training"])


def time_attention_at(torch, F, fa, ref, gen, card, b, hq, hkv, lq, lk,
                      d) -> dict:
    dt = torch.bfloat16
    q, k, v = attention_inputs(torch, gen, b, hq, hkv, lq, lk, d, dt)
    scale = 1.0 / math.sqrt(d)
    out = fa.flash_attention(q, k, v, causal=True, sm_scale=scale)
    want = ref.attention_ref(q, k, v, causal=True, sm_scale=scale)
    err = (out.float() - want.float()).abs().max().item()

    lib = fa._library()
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b,
            hq, hkv, lq, lk, d, d, lk, 1, 0, 0.0, scale, stream)
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
    log(f"  times at B{b} Hq{hq} Hkv{hkv} Lq{lq} Lk{lk} D{d} bf16 causal "
        f"({card}): kernel {kernel_ms:.5f} ms, wrapper {wrapper_ms:.5f} ms, "
        f"plain {plain_ms:.5f} ms, sdpa {library_ms:.5f} ms (sdpa max|err| "
        f"vs plain {sdpa_err:.3e}); bound {max(t_bytes, t_ops):.6f} ms "
        f"({nbytes} B, {ops_count} products-ops, {keys} of {lk} keys); "
        f"kernel / sdpa {kernel_ms / library_ms:.3f}")
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


def drive_engine(torch, eng, prompts, new_tokens):
    """Submit every prompt, step the engine until idle noting the host
    time each request's tokens arrive, then the final evict pass.
    Returns (rids, TTFT list (submit to the end of the admitting step),
    gaps between a request's tokens, wall); waits for the card at both
    ends."""
    torch.cuda.synchronize()
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
    ttft = [got_at[r][0] - t0 for r in rids]
    gaps = [b - a for r in rids for a, b in zip(got_at[r], got_at[r][1:])
            if b > a]
    return rids, ttft, gaps, wall


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
    rids, ttft, gaps, wall = drive_engine(torch, eng, prompts, new_tokens)
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
    stats = {"tokens": [eng.results[r].copy() for r in rids],
             "ttft_p50": pct(ttft, 50), "per_token_p50": pct(gaps, 50)}
    return eng, prompts, launches, stats


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
    # reduce_combine over both of its paths: the 16-byte vector path
    # (aligned bases and row strides) with its scalar tail, and the scalar
    # path (a base or a row stride off 16 bytes); k = 2, 3 and 4 (template
    # k), 17 and 33 (run-time k; 33 folds in two launches); NaN in the
    # float buffers for max/min
    def layouts(make):
        """(label, k views of one shape): contiguous; a ragged column count
        on aligned rows; the ring reduce-scatter's blocks of PE-stacked
        rows; a base one element off; a row stride off 16 bytes."""
        yield "contiguous", lambda: make((40, 256))
        yield "ragged cols", lambda: make((40, 256))[:, :203]
        yield "ring blocks", lambda: make((16, 1024))[:, 192:448]
        yield "base +1", lambda: make((40 * 256 + 1,))[1:].view(40, 256)
        yield "odd stride", lambda: make((40, 257))[:, :250]

    def buf(dt, op):
        def make(shape):
            b = rand(torch, gen, shape, dt)
            if dt.is_floating_point:
                b = b / 100
                if op in ("max", "min"):
                    b.view(-1)[::7] = float("nan")
            elif op == "prod":
                b = b % 5 - 2
            return b
        return make

    for dt in (f32, bf16, torch.float16, i32, torch.int8, f64,
               torch.int64):
        for op in ("sum", "prod", "max", "min"):
            for k in (2, 3, 4, 17, 33):
                for label, view in layouts(buf(dt, op)):
                    bufs = [view() for _ in range(k)]
                    bitwise(torch, rc.reduce_combine(bufs, op),
                            ref.reduce_combine_ref(bufs, op),
                            f"reduce_combine {dt} {op} k{k} {label}")
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
    # kernel and torch.add in alternating pairs (either first in turn),
    # after a warm-up of both; the medians of six readings each
    def kern():
        clib.repro_reduce_combine(ptrs, lds, 2, y.data_ptr(), n, L, 0, 0,
                                  stream)

    def add():
        torch.add(x, b, out=y)

    for _ in range(20):
        kern()
        add()
    pairs = []
    for i in range(6):
        t = {fn: time_ms(fn, iters=30, warmup=5)
             for fn in ((kern, add) if i % 2 else (add, kern))}
        pairs.append((t[kern], t[add]))
    k_ms = statistics.median(k for k, _ in pairs)
    add_ms = statistics.median(a for _, a in pairs)
    row("reduce_combine", err, k_ms,
        time_ms(lambda: ref.reduce_combine_ref([x, b], "sum"), iters=10,
                warmup=2),
        add_ms, 3 * nbytes, "two 16 x 64 MiB f32 buffers, sum")
    ratios = [k / a for k, a in pairs]
    log(f"  reduce_combine in 6 alternating pairs with torch.add: kernel / "
        f"torch.add median {statistics.median(ratios):.4f} (min "
        f"{min(ratios):.4f}, max {max(ratios):.4f}), the kernel faster in "
        f"{sum(r < 1 for r in ratios)} of 6; "
        f"{out['reduce_combine']['bound_ms'] / k_ms:.1%} of the byte bound")
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


# ---------------------------------------------------------------------------
# phase 6: training — kernel 5, the fused bucket, full-width steps
# ---------------------------------------------------------------------------

ADAM_HP = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd_coef=0.1)
# offsets (elements) of g_0.., p, m, v, mask into larger buffers: all
# aligned (the vector path), all odd or mixed (the outputs are aligned,
# so the scalar path); the strided (16, cols) cases below reach the
# vector path after a head
OFFSETS = {"aligned": lambda i: 0, "odd": lambda i: 1,
           "mixed": lambda i: 1 + i % 3}
# tolerances of phase 6e: the loss through the kernel relative to the
# loss through the plain attention, and every gradient leaf relative to
# its own max |value|.  f32: 1e-5 and 1e-3.  bf16: set from the readings
# of the H100 runs (loss rel 1.068e-4, worst leaf 3.585e-2, identical in
# each run), at about 9x and 3x above them
GRAD_RTOL = {"torch.float32": (1e-5, 1e-3), "torch.bfloat16": (1e-3, 0.1)}


def adam_inputs(torch, gen, k, n, mode, g_scale=1.0, zero=False):
    """k gradient chunks, p, m and v of length n, each a view at its
    OFFSETS[mode] element offset into a larger buffer (zero gradients and
    moments with `zero`), and a function placing a mask the same way."""
    off = OFFSETS[mode]

    def at(i, x):
        buf = torch.empty(n + 8, dtype=x.dtype, device="cuda")
        buf[off(i):off(i) + n] = x
        return buf[off(i):off(i) + n]

    def rnd(scale):
        return torch.randn(n, generator=gen, device="cuda") * scale

    gs = [at(i, torch.zeros(n, device="cuda") if zero else rnd(g_scale))
          for i in range(k)]
    p = at(k, rnd(1.0))
    m = at(k + 1, torch.zeros(n, device="cuda") if zero else rnd(0.1))
    v = at(k + 2, torch.zeros(n, device="cuda") if zero
           else rnd(0.01).abs())
    return gs, p, m, v, lambda mask: at(k + 3, mask)


def check_fused_update(torch) -> None:
    """Kernel 5 against its plain version, bit for bit: k 1-4; n 1, 7,
    1000, 1003, 2^20+3; aligned, odd and mixed offsets; f32 and bf16 out;
    t 1 and 1000 with scales 4 and 3; masks all zero, all one and
    alternating; (16, cols) chunks with strided gradient rows; then zero
    gradients and moments, and |g| up to 1e18."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = 0

    def one(gs, p, m, v, w, t, scale, out, what):
        nonlocal cases
        c1 = torch.tensor(1 - 0.9 ** t, device="cuda")
        c2 = torch.tensor(1 - 0.95 ** t, device="cuda")
        kw = dict(scale=scale, out_dtype=out, **ADAM_HP)
        got = fu.fused_adam(gs, p, m, v, w, c1, c2, **kw)
        want = ref.fused_adam_ref(gs, p, m, v, w, c1, c2, **kw)
        for name, a, b in zip("pmv", got, want):
            bitwise(torch, a, b, f"fused_update {what} {name}")
        cases += 1

    for k in (1, 2, 3, 4):
        for n in (1, 7, 1000, 1003, (1 << 20) + 3):
            for mode in OFFSETS:
                gs, p, m, v, at = adam_inputs(torch, gen, k, n, mode)
                masks = {"zero": torch.zeros(n, dtype=torch.int8,
                                             device="cuda"),
                         "one": torch.ones(n, dtype=torch.int8,
                                           device="cuda"),
                         "alt": (torch.arange(n, device="cuda") % 2).to(
                             torch.int8)}
                for mname, mask in masks.items():
                    w = at(mask)
                    for t, scale in ((1, 4.0), (1000, 3.0)):
                        for out in (torch.float32, torch.bfloat16):
                            one(gs, p, m, v, w, t, scale, out,
                                f"k{k} n{n} {mode} {mname} t{t} {out}")
    # PE-stacked (rows, cols) chunks, the gradients column blocks of a
    # wider buffer (as the ring's last local partial): ragged rows start
    # at every alignment, so rows take the vector path after a head, or
    # the scalar path
    for k in (1, 2, 4):
        for cols in (1000, 1003, (1 << 16) + 3):
            wide = torch.randn((16, k * cols + 1), generator=gen,
                               device="cuda")
            gs = [wide[:, 1 + j * cols:1 + (j + 1) * cols] for j in range(k)]
            p, m, v = (torch.randn((16, cols), generator=gen, device="cuda")
                       for _ in range(3))
            v = v.abs()
            w = (torch.arange(16 * cols, device="cuda") % 3 == 0).to(
                torch.int8).reshape(16, cols)
            for out in (torch.float32, torch.bfloat16):
                one(gs, p, m, v, w, 1000, 16.0, out,
                    f"k{k} 16 x {cols} strided {out}")
    for k in (1, 4):
        for g_scale, zero in ((1e18, False), (1e9, False), (1.0, True)):
            gs, p, m, v, at = adam_inputs(torch, gen, k, 1003, "odd",
                                          g_scale, zero)
            w = at((torch.arange(1003, device="cuda") % 2).to(torch.int8))
            for out in (torch.float32, torch.bfloat16):
                one(gs, p, m, v, w, 1, 1.0, out,
                    f"k{k} |g|~{g_scale:g} zero={zero} {out}")
    torch.cuda.synchronize()
    log(f"  fused_update: {cases} cases bit for bit with the plain version "
        f"(p, m, v)")


def time_fused_update(torch, n_params: int) -> dict:
    """Kernel 5 at the two shapes the training paths give it: the 16-PE
    bucket (k 2, 16 rows of 1,048,576) and the full-width step (k 1,
    every parameter once).  The kernel alone is its C entry called back
    to back; the plain version is `ref.fused_adam_ref`; no single PyTorch
    call computes the function (library: none)."""
    import ctypes
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    lib = fu._library()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, k, rows, cols in (("bucket16", 2, 16, 1 << 20),
                                 ("full", 1, 1, n_params)):
        gs = [torch.randn((rows, cols), generator=gen, device="cuda")
              for _ in range(k)]
        p = torch.randn((rows, cols), generator=gen, device="cuda")
        m = torch.randn((rows, cols), generator=gen, device="cuda") * 0.1
        v = torch.rand((rows, cols), generator=gen, device="cuda") * 0.01
        w = (torch.arange(cols, device="cuda") % 2).to(torch.int8) \
            .expand(rows, cols).contiguous()
        hyper = torch.tensor([1 - 0.9 ** 10, 1 - 0.95 ** 10], device="cuda")
        kw = dict(scale=float(k), out_dtype=torch.float32, **ADAM_HP)
        got = fu.fused_adam(gs, p, m, v, w, hyper[0], hyper[1], **kw)
        want = ref.fused_adam_ref(gs, p, m, v, w, hyper[0], hyper[1], **kw)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        del want
        po, mo, vo = got
        args = ((ctypes.c_void_p * k)(*[g.data_ptr() for g in gs]),
                (ctypes.c_int64 * k)(*[cols] * k), k, p.data_ptr(),
                m.data_ptr(), v.data_ptr(), w.data_ptr(), hyper.data_ptr(),
                po.data_ptr(), mo.data_ptr(), vo.data_ptr(), rows, cols, 0,
                ADAM_HP["lr"], ADAM_HP["b1"], ADAM_HP["b2"],
                1.0 - ADAM_HP["b1"], 1.0 - ADAM_HP["b2"], ADAM_HP["eps"],
                ADAM_HP["wd_coef"], float(k), stream)
        iters = 50 if label == "bucket16" else 10
        ms = time_ms(lambda: lib.repro_fused_adam(*args), iters=iters,
                     warmup=3)
        plain_ms = time_ms(lambda: ref.fused_adam_ref(
            gs, p, m, v, w, hyper[0], hyper[1], **kw), iters=5, warmup=1)
        nbytes = rows * cols * (4 * k + 13 + 12)
        flops = rows * cols * (k + 14)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_OPS_PER_S["torch.float32"] * 1e3
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=None, bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations")
        log(f"  fused_update {label} (k {k}, {rows} x {cols} f32): kernel "
            f"{ms:.5f} ms, plain {plain_ms:.5f} ms, library none; bound "
            f"{max(t_bytes, t_ops):.5f} ms ({nbytes} B at 3.35 TB/s), "
            f"max|err| {err}")
        del gs, p, m, v, w, got, po, mo, vo
        torch.cuda.empty_cache()
    return out


def fused_bucket(torch, np) -> dict:
    """fused_rs_adam + allgather_unpad on the paper's 16 PEs at the
    trainer's 64 MiB-per-PE f32 bucket, bit for bit against
    reduce_scatter + allgather_unpad + the plain AdamW on full moments
    (`tests/test_fused.py`'s identity contract, with nonzero moments and
    t 1000); each PE's owned moment chunks against the matching slices.
    Returns the launch counts of the fused call."""
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import collectives as coll
    from repro_torch.core import fusion, sim_ctx
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    from repro_torch.kernels import ref
    n, L = paper.N_PES, BUCKET_ELEMS
    chunk = -(-L // n)
    net = sim_ctx(n, paper.TOPOLOGY, device="cuda").net
    gen = torch.Generator(device="cuda").manual_seed(8)
    g = torch.randn((n, L), generator=gen, device="cuda")
    p = torch.randn(L, generator=gen, device="cuda").expand(n, L) \
        .contiguous()
    wd = (torch.arange(L, device="cuda") % 3 == 0).to(torch.int8)
    m = torch.randn((n, chunk), generator=gen, device="cuda") * 0.1
    v = torch.rand((n, chunk), generator=gen, device="cuda") * 0.01
    c1 = torch.tensor(1 - 0.9 ** 1000, device="cuda")
    c2 = torch.tensor(1 - 0.95 ** 1000, device="cuda")
    kw = dict(scale=float(n), out_dtype=torch.float32, **ADAM_HP)

    def fused():
        new_p, new_m, new_v, info = fusion.fused_rs_adam(
            net, g, p, m, v, wd, c1, c2, **kw)
        return coll.allgather_unpad(net, new_p, info), new_m, new_v

    torch.cuda.synchronize()
    pc.launches = pc.dma_launches = rc.launches = fu.launches = 0
    full, new_m, new_v = fused()                  # the path's one call
    torch.cuda.synchronize()
    got = {"put_copy": pc.launches, "dma_copy": pc.dma_launches,
           "reduce_combine": rc.launches, "fused_update": fu.launches}
    stages = len(coll.reduce_scatter_schedule(n).stages)
    want = {"put_copy": stages + len(coll.allgather_schedule(n).stages),
            "dma_copy": 2, "reduce_combine": stages - 1, "fused_update": 1}
    if got != want:
        raise AssertionError(f"fused bucket launches {got}, the schedules "
                             f"imply {want}")

    own = (torch.arange(n, device="cuda") + 1) % n
    m_full = torch.zeros(chunk * n, device="cuda")
    v_full = torch.zeros(chunk * n, device="cuda")
    m_full.view(n, chunk)[own] = m
    v_full.view(n, chunk)[own] = v
    g_sum = coll.allgather_unpad(net, *coll.reduce_scatter(net, g))
    want_p, want_m, want_v = ref.fused_adam_ref(
        [g_sum], p, m_full[:L].expand(n, L), v_full[:L].expand(n, L),
        wd.expand(n, L), c1, c2, **kw)
    del g_sum
    bitwise(torch, full, want_p, "fused bucket p")
    if not torch.equal(full, full[:1].expand_as(full)):
        raise AssertionError("fused bucket: PEs disagree")
    idx = own[:, None] * chunk + torch.arange(chunk, device="cuda")
    bitwise(torch, new_m, torch.gather(want_m, 1, idx), "fused bucket m")
    bitwise(torch, new_v, torch.gather(want_v, 1, idx), "fused bucket v")
    del want_p, want_m, want_v, full
    walls = {}
    for label, fn in (("fused", fused), ("unfused", lambda: ref.fused_adam_ref(
            [coll.allgather_unpad(net, *coll.reduce_scatter(net, g))], p,
            m_full[:L].expand(n, L), v_full[:L].expand(n, L),
            wd.expand(n, L), c1, c2, **kw))):
        ts = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        walls[label] = ts
    log(f"  fused_rs_adam on 16 PEs x 64 MiB f32: bit for bit with "
        f"reduce_scatter + allgather_unpad + plain AdamW (p, owned m, v); "
        f"launches {got}; wall ms fused "
        + ", ".join(f"{w:.3f}" for w in walls["fused"]) + ", unfused "
        + ", ".join(f"{w:.3f}" for w in walls["unfused"]))
    del g, p, m, v, m_full, v_full
    torch.cuda.empty_cache()
    return got


def _counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.kernels import ssd_scan as ks
    return {"flash_attention": fa.launches, "put_copy": pc.launches,
            "dma_copy": pc.dma_launches, "reduce_combine": rc.launches,
            "fused_update": fu.launches, "ssd_scan": ks.launches,
            "ring_attention": ra.launches}


def _reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.kernels import ssd_scan as ks
    fa.launches = pc.launches = pc.dma_launches = rc.launches = 0
    fu.launches = ks.launches = ra.launches = 0


def train(torch, np, serving) -> dict:
    """6c: qwen2-0.5b at full width, TRAIN_RUN's steps through the
    launcher (default sync: apply_updates) and as many through
    build_train_step(grad_rs="fused") from the same seed-0 weights.
    Returns the launch counts of both runs and what 6d needs."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep
    cfg, run = serving.CONFIG, serving.TRAIN_RUN
    steps, tokens = run["steps"], run["seq_len"] * run["batch"]
    per_step_fa = 2 * cfg.n_layers * cfg.microbatches

    def report(label, losses, walls, peak, counts):
        tok_s = tokens * (len(walls) - 1) / sum(walls[1:])
        log(f"  train {label}: {steps} steps, losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f"; step wall ms " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
            + f"; {tok_s:.1f} train tok/s (steps 2..{steps}); peak device "
            f"memory {peak / 2**30:.3f} GiB; launches {counts}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"train {label}: non-finite loss")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"train {label}: loss did not fall")
        if counts["flash_attention"] != per_step_fa * steps:
            raise AssertionError(
                f"train {label}: flash_attention launched "
                f"{counts['flash_attention']} times, want 2 x "
                f"{cfg.n_layers} x {cfg.microbatches} x {steps}")

    argv = ["--arch", "qwen2-0.5b", "--steps", str(steps), "--seq-len",
            str(run["seq_len"]), "--batch", str(run["batch"]), "--lr",
            str(run["lr"]), "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                 # path (i) starts
    res = train_mod.run(argv)
    torch.cuda.synchronize()
    counts_i = _counts()                            # path (i) ends
    report("(i) launcher, default sync", res.losses, res.step_s,
                   torch.cuda.max_memory_allocated(), counts_i)
    if counts_i["fused_update"] != 0:
        raise AssertionError("the default sync launched kernel 5")

    adamw = opt.AdamWConfig(lr=run["lr"], moment_dtype=cfg.moment_dtype)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    n_buckets = len(tstep.plan_fused_buckets(tree_flatten(params)[0]))
    state = tstep.init_fused_opt_state(params)
    step = tstep.build_train_step(cfg, adamw=adamw, grad_rs="fused")
    pipe = SyntheticLM(cfg.vocab, run["seq_len"], run["batch"])
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                 # path (ii) starts
    for s in range(steps):
        t0 = time.perf_counter()
        loss, params, state = step(params, state, pipe.batch(s))
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts_ii = _counts()                           # path (ii) ends
    report("(ii) fused sync", losses, walls,
                    torch.cuda.max_memory_allocated(), counts_ii)
    if counts_ii["fused_update"] != n_buckets * steps:
        raise AssertionError(f"kernel 5 launched {counts_ii['fused_update']} "
                             f"times, want {n_buckets} buckets x {steps}")
    log(f"  step-0 loss: launcher {res.losses[0]!r}, fused {losses[0]!r}; "
        f"{n_buckets} fused buckets of at most 64 MiB")
    del params, state
    torch.cuda.empty_cache()
    return dict(counts=[counts_i, counts_ii], params=res.params, opt_state=res.opt_state, adamw=adamw,
                batch=pipe.batch(steps), n_params=sum(
                    l.numel() for l in tree_flatten(res.params)[0]))


def same_grads_both_optimizers(torch, serving, trained) -> None:
    """6d: one gradient tree, computed once, through apply_updates and
    through fused_adam_sync (moments packed from the same state): the new
    parameters and moments bit for bit."""
    from repro_torch.core import heap
    from repro_torch.core.heap import tree_flatten
    from repro_torch.parallel import sharding
    from repro_torch.parallel.comm import Comm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep
    cfg = serving.CONFIG
    params, state, adamw = (trained["params"], trained["opt_state"],
                            trained["adamw"])
    comm = Comm()
    batch = tstep.batch_to_device(trained["batch"], "cuda")
    _, grads = tstep.loss_and_grads(comm, cfg, params, batch,
                                    cfg.microbatches)
    leaves = tree_flatten(params)[0]
    buckets = tstep.plan_fused_buckets(leaves)
    specs = [heap.plan_pack([leaves[i] for i in idxs], dtype=torch.float32)
             for idxs in buckets]
    fstate = {"step": state["step"], "fused": [
        {key: heap.pack([state["mv"][i][key] for i in idxs], spec)
         for key in ("m", "v")} for idxs, spec in zip(buckets, specs)]}
    new_a, st_a = opt.apply_updates(params, grads, state, adamw)
    new_f, st_f = tstep.fused_adam_sync(
        comm, params, grads, fstate, adamw,
        sharding.needs_data_sync(cfg, params))
    torch.cuda.synchronize()
    for i, (a, f) in enumerate(zip(tree_flatten(new_a)[0],
                                   tree_flatten(new_f)[0])):
        bitwise(torch, f, a, f"6d param leaf {i}")
    for idxs, spec, mv in zip(buckets, specs, st_f["fused"]):
        for key in ("m", "v"):
            for i, val in zip(idxs, heap.unpack(mv[key], spec)):
                bitwise(torch, val, st_a["mv"][i][key], f"6d {key} {i}")
    log(f"  one gradient tree through apply_updates and fused_adam_sync: "
        f"{len(leaves)} params and their m, v bit for bit ({len(buckets)} "
        f"buckets, step {int(st_a['step'])})")


def grads_through_the_kernel(torch, np, serving, ref, layers) -> None:
    """6e: one microbatch at full width: the loss and every gradient leaf
    through the flash kernel (its Function's reference-recompute
    backward) against those through the plain attention, in f32 and
    bf16, each within GRAD_RTOL."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.parallel.comm import Comm
    from repro_torch.train import step as tstep
    cfg, run = serving.CONFIG, serving.TRAIN_RUN
    rows = run["batch"] // cfg.microbatches
    batch = {k: v[:rows] for k, v in
             SyntheticLM(cfg.vocab, run["seq_len"], run["batch"]).batch(0)
             .items()}
    batch = tstep.batch_to_device(batch, "cuda")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dtype)
        before = fa.launches
        loss_k, g_k = tstep.loss_and_grads(Comm(), c, params, batch)
        if fa.launches - before != 2 * cfg.n_layers:
            raise AssertionError("6e: the kernel path did not launch the "
                                 "kernel in every layer")
        with mock.patch.object(layers.kops, "attention", ref.attention_ref):
            loss_p, g_p = tstep.loss_and_grads(Comm(), c, params, batch)
        rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(tree_flatten(g_k)[0],
                                    tree_flatten(g_p)[0]))
        log(f"  grads through the kernel vs plain attention, {dtype}: loss "
            f"{float(loss_k):.6f} vs {float(loss_p):.6f} (rel {rel_loss:.3e})"
            f", worst leaf max|diff|/max|grad| {worst:.3e}")
        loss_tol, leaf_tol = GRAD_RTOL[str(dtype)]
        if not (rel_loss <= loss_tol and worst <= leaf_tol):
            raise AssertionError(f"6e {dtype}: loss rel {rel_loss} (tol "
                                 f"{loss_tol}), worst leaf {worst} (tol "
                                 f"{leaf_tol})")
        del g_k, g_p
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: serve mamba2-2.7b at full width — kernel 7, prefill, decode
# ---------------------------------------------------------------------------

# kernel 7 against ref.ssd_chunked_ref: y in f32 and the f32 state within
# tests/test_kernels.py's atol 2e-4, scaled by |want| where that is above
# 1 (model-scale values); y in bf16 within the larger of 3e-2 and one bf16
# step of |want| (phase 2's rule for a rounded output)
SSD_ATOL = 2e-4
# the prefill's last-position logits through kernel 7 against those
# through the plain version, relative to the largest logit, with f32
# compute: 1e-2.  In bf16 no such gate can tell a right kernel from a
# wrong one: the random-weight 64-layer stack amplifies each flipped bf16
# rounding of y.  A CPU probe at reduced width (d 256, L 1024; the plain
# version at chunk 128 against chunk 64, two f32 orders of the same sums)
# moved the bf16 logits by 1.1% of the largest at 4 layers, 3.2% at 16
# and 27% at 64, the f32 logits by 1.4e-5, 3.3e-5 and 4.8e-4.  So the
# bf16 prefill holds kernel 7 to the plain version layer by layer, on each
# layer's own inputs (the rule of 7a), and prints the end-to-end
# difference; the f32 prefill gates it at 20x the probe's reading
MAMBA_F32_LOGITS_RTOL = 1e-2


def ssd_inputs(torch, gen, b, seq, h, p, n, g, dtype, *, scale=0.3,
               model=False, h0=False):
    """x, dt, A, B, C, h0 on the card.  tests/test_kernels.py's draws (x,
    B, C at `scale`, dt in [0, 0.5), A in (-1.1, -0.1], h0 at 0.2), or
    with `model` the mamba2 layer's: A = -linspace(1, 16, H) (`a_log`'s
    init) and dt = softplus(N(0, 1)) (dt_bias 0)."""
    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s
    x = rnd(b, seq, h, p, s=scale).to(dtype)
    if model:
        dt = torch.nn.functional.softplus(rnd(b, seq, h))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
    else:
        dt = torch.rand(b, seq, h, generator=gen, device="cuda") * 0.5
        a = -torch.rand(h, generator=gen, device="cuda") - 0.1
    bm = rnd(b, seq, g, n, s=scale).to(dtype)
    cm = rnd(b, seq, g, n, s=scale).to(dtype)
    return x, dt, a, bm, cm, (rnd(b, h, p, n, s=0.2) if h0 else None)


def ssd_cases():
    """(label, B, L, H, P, N, G, chunk, dtype name, options)."""
    cases = []
    for dtype, scale in (("float32", 0.3), ("bfloat16", 1.0)):
        for seq, q in ((64, 16), (64, 64), (48, 16)):   # test_kernels
            for g in (1, 2):
                cases.append((f"tests_L{seq}q{q}", 2, seq, 4, 16, 8, g, q,
                              dtype, dict(scale=scale)))
        cases.append(("tests_h0", 1, 32, 2, 8, 4, 1, 8, dtype,
                      dict(scale=scale, h0=True)))
        cases.append(("ragged_L50q16", 2, 50, 4, 16, 8, 2, 16, dtype,
                      dict(scale=scale, h0=True)))
        cases.append(("ragged_L200q128", 1, 200, 8, 64, 128, 1, 128, dtype,
                      dict(scale=scale)))
        # the model's head shape and A, dt draws; "strided" slices x, B, C
        # out of one (B, L, H*P + 2*N) tensor, as mamba2 hands them over
        cases.append(("model_L4096", 1, 4096, 80, 64, 128, 1, 128, dtype,
                      dict(scale=scale, model=True)))
        cases.append(("model_strided", 1, 1024, 80, 64, 128, 1, 128, dtype,
                      dict(scale=scale, model=True, strided=True)))
    return cases


def ssd_over(torch, y, h, want_y, want_h):
    """(worst err/limit, max|err| of y, of the state, smallest y limit):
    y in bf16 within the larger of 3e-2 and one bf16 step of |want|, y in
    f32 and the f32 state within SSD_ATOL x max(1, |want|)."""
    dy = (y.float() - want_y.float()).abs()
    dh = (h - want_h).abs()
    if y.dtype == torch.bfloat16:
        lim_y = torch.maximum(torch.full_like(dy, TOL[str(y.dtype)]),
                              ulp(torch, want_y))
    else:
        lim_y = SSD_ATOL * want_y.float().abs().clamp_min(1.0)
    lim_h = SSD_ATOL * want_h.abs().clamp_min(1.0)
    over = max((dy / lim_y).max().item(), (dh / lim_h).max().item())
    return over, dy.max().item(), dh.max().item(), lim_y.min().item()


def check_ssd(torch, ops, ref, gen) -> float:
    """Kernel 7 through ops.ssd against the plain chunked version on the
    same inputs, each case within its limit, and each of its phases held
    to its plain form (`ssd_phases_over`); returns the worst err/limit.
    Then the sequential-scan oracle against the plain chunked version."""
    worst, worst_phase = check_ssd_cases(torch, ops, ref, gen, ssd_cases())
    x, dt, a, bm, cm, h0 = ssd_inputs(torch, gen, 2, 64, 4, 16, 8, 2,
                                      torch.float32, h0=True)
    ys, hs = ref.ssd_ref(x, dt, a, bm, cm, h0)
    yc, hc = ref.ssd_chunked_ref(x, dt, a, bm, cm, h0, chunk=16)
    err = max((ys - yc).abs().max().item(), (hs - hc).abs().max().item())
    log(f"  ssd_ref (sequential scan) vs ssd_chunked_ref, L64 Q16 G2 with "
        f"h0: max|err| {err:.3e} (atol {SSD_ATOL}); worst err/limit of the "
        f"kernel's y and state {worst:.3f}, of its phases {worst_phase:.3f}")
    if not err <= SSD_ATOL:
        raise AssertionError(f"ssd_ref vs ssd_chunked_ref: {err}")
    return worst


def check_ssd_cases(torch, ops, ref, gen, cases) -> tuple[float, float]:
    """Each case of `cases` (ssd_cases' tuples) through ops.ssd against
    the plain chunked version on its own inputs, and each of the kernel's
    phases against its plain form; returns the worst err/limit of y and
    the state, and of the phases."""
    worst = worst_phase = 0.0
    for label, b, seq, h, p, n, g, q, dtype, opt in cases:
        dt_ = getattr(torch, dtype)
        opt = dict(opt)
        strided = opt.pop("strided", False)
        x, dt, a, bm, cm, h0 = ssd_inputs(torch, gen, b, seq, h, p, n, g,
                                          dt_, **opt)
        if strided:
            fused = torch.cat([x.reshape(b, seq, h * p),
                               bm.reshape(b, seq, g * n),
                               cm.reshape(b, seq, g * n)], -1)
            x = fused[..., :h * p].reshape(b, seq, h, p)
            bm = fused[..., h * p:h * p + g * n].reshape(b, seq, g, n)
            cm = fused[..., h * p + g * n:].reshape(b, seq, g, n)
            assert not x.is_contiguous()
        y, hf = ops.ssd(x, dt, a, bm, cm, h0, chunk=q)
        want_y, want_h = ops._ssd_padded(x, dt, a, bm, cm, h0, q,
                                         ref.ssd_chunked_ref)
        torch.cuda.synchronize()
        if y.shape != want_y.shape or y.dtype != dt_ \
                or hf.dtype != torch.float32:
            raise AssertionError(f"ssd {label}: {y.shape}/{y.dtype}, state "
                                 f"{hf.dtype}")
        if not (torch.isfinite(y).all() and torch.isfinite(hf).all()):
            raise AssertionError(f"ssd {label} {dtype}: non-finite output")
        over, err_y, err_h, min_lim = ssd_over(torch, y, hf, want_y, want_h)
        typical = want_y.float().abs().mean().item()
        phases = ssd_phases_over(torch, ops, ref, x, dt, a, bm, cm, h0, q)
        log(f"  ssd {label:16s} {dtype:8s} B{b} L{seq} H{h} P{p} N{n} G{g} "
            f"Q{q}: max|err| y {err_y:.3e}, state {err_h:.3e} (worst "
            f"err/limit {over:.3f}, mean|y| {typical:.4f}); phases "
            + " ".join(f"{k} {v:.3f}" for k, v in phases.items()))
        if not over <= 1.0:
            raise AssertionError(f"ssd {label} {dtype}: err/limit {over}")
        for phase, v in phases.items():
            if not v <= 1.0:
                raise AssertionError(f"ssd {label} {dtype}: phase {phase} "
                                     f"err/limit {v}")
        worst_phase = max(worst_phase, max(phases.values()))
        if not typical > 10 * min_lim:
            raise AssertionError(f"ssd {label} {dtype}: mean|y| {typical} "
                                 f"is not far above the tolerance")
        worst = max(worst, over)
    return worst, worst_phase


def ssd_phases_over(torch, ops, ref, x, dt, a, bm, cm, h0, q) -> dict:
    """Kernel 7's phases, each held to its plain form on the kernel's own
    inputs to that phase, so that a fault names its phase: the cumsums s
    to `ref.ssd_chunk_states_ref`'s; the chunk states to the same
    function given the kernel's s; the entering and final states to
    `ref.ssd_state_passing_ref` on the kernel's chunk states and s; y to
    `ref.ssd_chunk_outputs_ref` on the kernel's s and entering states.  f32
    intermediates within SSD_ATOL x max(1, |want|), y within ssd_over's
    limit.  Returns {phase: worst err/limit}."""
    x, dt, bm, cm = ops._ssd_pad(x, dt, bm, cm, q)
    got = ops._ssd.ssd_scan_phases(x, dt, a, bm, cm, h0, chunk=q)
    s_want, _ = ref.ssd_chunk_states_ref(x, dt, a, bm, q)
    _, local = ref.ssd_chunk_states_ref(x, dt, a, bm, q, s=got["s"])
    entering, final = ref.ssd_state_passing_ref(got["chunk_states"],
                                                got["s"], h0)
    y = ref.ssd_chunk_outputs_ref(x, dt, bm, cm, got["s"], got["entering"],
                                  q)

    def f32_over(g_, w_):
        return ((g_ - w_).abs() / (SSD_ATOL * w_.abs().clamp_min(1.0))
                ).max().item()

    return {"s": f32_over(got["s"], s_want),
            "chunk states": f32_over(got["chunk_states"], local),
            "entering": f32_over(got["entering"], entering),
            "final": f32_over(got["final"], final),
            "y": ssd_over(torch, got["y"], final, y, final)[0]}


def ssd_counts(b, seq, h, p, n, g, q, itemsize) -> tuple[int, int]:
    """(bytes, products-ops) the SSD scan needs: x, dt, A, B, C read once,
    y and the f32 state written once; the products of the pairs u <= t the
    mask keeps, C B^T once per group (its heads share it), and per head
    the intra term, C @ state^T and the state update."""
    nbytes = (2 * b * seq * h * p * itemsize + b * seq * h * 4 + h * 4
              + 2 * b * seq * g * n * itemsize + b * h * p * n * 4)
    pairs = q * (q + 1) // 2
    per_chunk = 2 * n * pairs * g + h * (2 * p * pairs + 4 * q * n * p)
    return nbytes, b * (seq // q) * per_chunk


# one layer's scan in a 32768-token prefill: (Bt, L, H, P, N, G, chunk)
MAMBA_SSD_SHAPE = (1, 32768, 80, 64, 128, 1, 128)
ZAMBA_SSD_SHAPE = (1, 32768, 64, 64, 64, 1, 128)


def time_ssd(torch, kssd, ref, gen, shape=MAMBA_SSD_SHAPE) -> dict:
    """Kernel 7 at a prefill's shapes (one layer's scan; default the
    mamba2-2.7b prefill's): its C entry back to back (three CUDA kernels,
    timed alone by the profiler too), the wrapper (which allocates the
    scratch), and the plain version.  The bound is that of the arithmetic
    the kernel uses: the bf16 path's products on the tensor cores (the
    f32 CUDA-core figure beside it)."""
    b, seq, h, p, n, g, q = shape
    x, dt, a, bm, cm, _ = ssd_inputs(torch, gen, b, seq, h, p, n, g,
                                     torch.bfloat16, scale=1.0, model=True)
    y, hf = kssd.ssd_scan(x, dt, a, bm, cm, chunk=q)
    want_y, want_h = ref.ssd_chunked_ref(x, dt, a, bm, cm, chunk=q)
    err = (y.float() - want_y.float()).abs().max().item()
    lib = kssd._library()
    stream = torch.cuda.current_stream().cuda_stream
    states = torch.empty((b, seq // q, h, p, n), device="cuda")
    s_buf = torch.empty((b, seq // q, h, q), device="cuda")
    args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), None, y.data_ptr(), hf.data_ptr(),
            states.data_ptr(), s_buf.data_ptr(), 1, b, seq, h, g, p, n, q, 3,
            x.stride(0), x.stride(1), bm.stride(0), bm.stride(1),
            cm.stride(0), cm.stride(1), stream)
    kernel_ms = time_ms(lambda: lib.repro_ssd_scan(*args), iters=20,
                        warmup=2)
    wrapper_ms = time_ms(lambda: kssd.ssd_scan(x, dt, a, bm, cm, chunk=q),
                         iters=20, warmup=2)
    plain_ms = time_ms(lambda: ref.ssd_chunked_ref(x, dt, a, bm, cm,
                                                   chunk=q),
                       iters=3, warmup=1)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(5):
            lib.repro_ssd_scan(*args)
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        name = re.search(r"(chunk_state|state_pass|chunk_output)_kernel",
                         e.key)
        if name and e.device_time_total > 0:
            per_kernel[name.group(0)] = e.device_time_total / 1e3 / 5
    nbytes, ops_count = ssd_counts(b, seq, h, p, n, g, q, 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS_PER_S["torch.bfloat16"] * 1e3
    t_f32 = ops_count / PEAK_OPS_PER_S["torch.float32"] * 1e3
    full_q = b * (seq // q) * h * (2 * q * q * (n + p) + 4 * q * n * p)
    smem = {ph: lib.repro_ssd_scan_smem_bytes(p, n, q, 1, ph)
            for ph in (1, 3)}
    log(f"  times at B{b} L{seq} H{h} P{p} N{n} G{g} Q{q} bf16: kernel "
        f"{kernel_ms:.5f} ms (three CUDA kernels, by the profiler: "
        + ", ".join(f"{k} {v:.5f} ms" for k, v in per_kernel.items())
        + f"), wrapper {wrapper_ms:.5f} ms, plain {plain_ms:.5f} ms; "
        f"max|err| vs plain {err:.3e}; dynamic shared memory a block: "
        f"phase 1 {smem[1]} B, phase 3 {smem[3]} B")
    log(f"  bound {max(t_bytes, t_ops):.6f} ms ({nbytes} B = {t_bytes:.6f} "
        f"ms; {ops_count} products-ops = {t_ops:.6f} ms at the bf16 "
        f"tensor-core rate, {t_f32:.6f} ms at the f32 CUDA-core rate; the "
        f"full Q x Q per head is {full_q} = "
        f"{full_q / PEAK_OPS_PER_S['torch.float32'] * 1e3:.6f} ms at f32); "
        f"kernel at {max(t_bytes, t_ops) / kernel_ms:.2%} of it; scratch "
        f"{(states.numel() + s_buf.numel()) * 4} B of states and cumsums")
    log("  ssd_scan library_ms: none; no PyTorch call computes the SSD "
        "chunked scan (the plain version is a dozen einsum/cumsum/exp "
        "calls and a loop over the chunks)")
    del x, dt, bm, cm, y, hf, want_y, want_h, states, s_buf
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=kernel_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, library_ms=None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def serve_mamba(torch, np, mamba, ops, ref) -> dict:
    """7c: build_prefill on mamba2-2.7b at full width (seeded random
    weights, bf16 compute on f32 weights) over SERVE_RUN's prompt: 64
    ssd_scan launches and finite logits.  Then the same prefill through
    the plain version, kernel 7 held to it in every layer on the layer's
    own inputs, and the prefill in f32 compute through both, its logits
    within MAMBA_F32_LOGITS_RTOL of the largest.  Returns the launch counts
    of the path."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    cfg, run = mamba.CONFIG, mamba.SERVE_RUN
    params = transformer.init_params(cfg, seed=0, device="cuda")
    n_params = sum(w.numel() for w in tree_flatten(params)[0])
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(
        1, cfg.vocab, size=(run["prefill_batch"], run["prefill_len"])),
        device="cuda")
    prefill = sstep.build_prefill(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                  # path starts
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()                               # path ends
    peak = torch.cuda.max_memory_allocated()
    log(f"  prefill {cfg.name} ({n_params} parameters, {cfg.n_layers} "
        f"layers, d {cfg.d_model}, vocab {cfg.vocab}), batch "
        f"{run['prefill_batch']} x L {run['prefill_len']}: wall {wall:.3f} s "
        f"({run['prefill_batch'] * run['prefill_len'] / wall:.1f} prompt "
        f"tok/s), peak memory {peak / 2**30:.3f} GiB, launches {counts}")
    if counts["ssd_scan"] != cfg.n_layers:
        raise AssertionError(f"ssd_scan launched {counts['ssd_scan']} times "
                             f"in the prefill, want {cfg.n_layers}")
    if logits.shape != (run["prefill_batch"], 1, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    # the same prefill through the plain version; each layer's kernel 7
    # output on that layer's inputs held to the plain output
    kernel_scan, layer_over = ops._ssd.ssd_scan, []

    def plain_and_kernel(x, dt, a, bm, cm, h0=None, *, chunk):
        want = ref.ssd_chunked_ref(x, dt, a, bm, cm, h0, chunk=chunk)
        got = kernel_scan(x, dt, a, bm, cm, h0, chunk=chunk)
        layer_over.append(ssd_over(torch, *got, *want)[0])
        return want

    t0 = time.perf_counter()
    with mock.patch.object(ops._ssd, "ssd_scan", plain_and_kernel):
        plain = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    both_wall = time.perf_counter() - t0
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  kernel 7 vs plain on each layer's inputs in the bf16 prefill: "
        f"{len(layer_over)} layers, worst err/limit {max(layer_over):.3f} "
        f"(first, middle, last layer: {layer_over[0]:.3f}, "
        f"{layer_over[len(layer_over) // 2]:.3f}, {layer_over[-1]:.3f}); "
        f"plain + kernel prefill wall "
        f"{both_wall:.3f} s")
    log(f"  bf16 prefill logits, kernel path vs plain path (not gated, see "
        f"MAMBA_F32_LOGITS_RTOL): max|err| {err:.4e}, max|logit| "
        f"{scale:.4f}, {err / scale / 2.0 ** -8:.2f} bf16 ulps of the "
        f"largest; argmax {int(logits.argmax())} vs {int(plain.argmax())}")
    if len(layer_over) != cfg.n_layers or not max(layer_over) <= 1.0:
        raise AssertionError(f"kernel 7 in the prefill's layers: "
                             f"{layer_over}")
    del logits, plain
    torch.cuda.empty_cache()
    prefill32 = sstep.build_prefill(dataclasses.replace(cfg,
                                                        dtype=torch.float32))
    t0 = time.perf_counter()
    logits = prefill32(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    with mock.patch.object(ops._ssd, "ssd_scan", ref.ssd_chunked_ref):
        plain = prefill32(params, {"tokens": tokens})
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  f32 prefill logits, kernel path vs plain path: max|err| "
        f"{err:.4e}, max|logit| {scale:.4f}, rel {err / scale:.3e} (tol "
        f"{MAMBA_F32_LOGITS_RTOL}); argmax {int(logits.argmax())} vs "
        f"{int(plain.argmax())}; kernel-path wall {wall32:.3f} s")
    if not (torch.isfinite(logits).all()
            and err <= MAMBA_F32_LOGITS_RTOL * scale):
        raise AssertionError(f"f32 prefill logits differ by {err} "
                             f"(max|logit| {scale})")
    del logits, plain, tokens, params
    torch.cuda.empty_cache()
    return counts


def decode_loop(torch, np, arch, cfg=None) -> None:
    """7d, 9d, 11b, 11c: `python -m repro_torch.launch.serve --arch
    <arch>` through its main() (the dense-cache decode loop at the
    reference's defaults; `arch` is the config module), or with `cfg` (a
    cut of arch's CONFIG, which no launcher flag names) the launcher's
    `_decode_loop` on it at those defaults; then the loop's logits at
    the last prompt position against build_prefill's on the same prompts
    and weights."""
    import argparse
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    run = arch.SERVE_RUN
    seen = {}
    real = transformer.decode_step

    def spy(comm, cfg_, params_, cache, tokens, positions):
        logits, cache = real(comm, cfg_, params_, cache, tokens, positions)
        step = seen.setdefault("steps", 0)
        if step == run["prompt_len"] - 1:
            seen.update(logits=logits.clone(), params=params_)
        seen["steps"] = step + 1
        return logits, cache

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(transformer, "decode_step", spy):
        if cfg is None:
            cfg = arch.CONFIG
            gen = launch_serve.main(["--arch", cfg.name])
        else:
            gen = launch_serve._decode_loop(cfg, torch.device("cuda"),
                                            argparse.Namespace(
                batch=run["batch"], prompt_len=run["prompt_len"],
                tokens=run["new_tokens"], cache_len=run["cache_len"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = (run["batch"], run["new_tokens"])
    entry = ("main" if cfg is arch.CONFIG
             else f"_decode_loop, {cfg.n_layers} layers")
    log(f"  decode loop (launch.serve {entry}, batch {run['batch']}, prompt "
        f"{run['prompt_len']}, {run['new_tokens']} tokens): tokens "
        f"{gen.shape}, wall {wall:.3f} s with the weights' init, "
        f"{gen.size / wall:.1f} tok/s, peak memory {peak / 2**30:.3f} GiB, "
        f"{seen['steps']} decode steps; first row {gen[0].tolist()}")
    if gen.shape != want or seen["steps"] != run["prompt_len"] \
            + run["new_tokens"] - 1:
        raise AssertionError(f"decode loop gave {gen.shape} in "
                             f"{seen['steps']} steps, want {want}")
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(run["batch"], run["prompt_len"]), dtype=np.int32)
    pre = sstep.build_prefill(cfg)(seen["params"], {"tokens": torch.as_tensor(
        prompts, device="cuda").long()})
    diff = (seen["logits"] - pre).abs().max().item()
    scale = pre.abs().max().item()
    log(f"  decode-loop logits at the last prompt position vs build_prefill"
        f"'s on the same prompts: max|diff| {diff:.4e}, max|logit| "
        f"{scale:.4f} (the one-step decode vs the full-sequence path in "
        f"bf16; the CPU test of the smoke config gates 0.12; in the moe "
        f"family a step routes at its own capacity, so they differ more)")
    if not np.isfinite(diff):
        raise AssertionError("decode-loop or prefill logits are not finite")
    seen.clear()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: sequence-sharded ring attention — kernel 6, the ring on 16 PEs
# ---------------------------------------------------------------------------

NEG_INF = -1e30
# 8a's limits, kernel 6 against its plain version on the same inputs: for
# a row that keeps a key, m within RING_M_RTOL x max(1, |m|) (a max logit
# near 0 has no relative precision left), l within RING_M_RTOL relative,
# acc within RING_ACC_TOL x max(1, l |v|max) (|acc| <= l |v|max); a row
# that keeps none: m exactly -1e30, l exactly the plain l (the count of
# the block's slots), acc within the same acc limit.  Then finalize of
# both within RING_OUT_ATOL (tests/test_fused.py's 2e-5, at D 16).  The m,
# l and finalize limits are for D 16 and grow as sqrt(D / 16): the logits
# are f32 dot products of D terms summed in two orders (the kernel's FMA
# chain, cuBLAS's GEMM), whose difference grows as sqrt(D), and l and the
# output inherit it.  The H100 run read, under the D-16 limits, worst l at
# 0.31, 0.50, 0.61 and 1.05 of the limit at D 16, 32, 64 and 128 (finalize
# 1.25 at D 128), masked rows exact everywhere.
RING_M_RTOL = 1e-5
RING_ACC_TOL = 2e-5
RING_OUT_ATOL = 2e-5


def ring_positions(torch, gen, layout, p, lq, lk, step=0):
    """(q_pos (P, Lq), k_pos (P, Lk)) int32 on the card.  "ring": PE p's
    queries at p*Lq.., its block from PE (p - step) % P at src*Lk.. (a
    ring step: past, diagonal and future blocks side by side); "future":
    every key after every query (wholly masked under causal); "kept":
    every key before every query (wholly kept under causal); "partly":
    keys from the middle of the query rows on (the early rows keep
    nothing); "late": a ring step with each block's keys in falling
    order, so a row keeps its first key after masked tiles; "pad": a ring
    step with ~15% of the key slots at -1; "shard": a ring step whose
    last PE holds a short shard, its last third of query and key slots at
    -1."""
    pe = torch.arange(p, device="cuda")[:, None]
    q_pos = pe * lq + torch.arange(lq, device="cuda")
    src = (pe - step) % p
    k_pos = src * lk + torch.arange(lk, device="cuda")
    if layout == "future":
        k_pos = k_pos + p * lq + 7
    elif layout == "kept":
        q_pos = q_pos + p * lk
    elif layout == "partly":
        k_pos = q_pos[:, :1] + lq // 2 + torch.arange(lk, device="cuda")
    elif layout == "late":
        k_pos = k_pos.flip(1)
    elif layout == "pad":
        drop = torch.rand((p, lk), generator=gen, device="cuda") < 0.15
        k_pos = torch.where(drop, torch.full_like(k_pos, -1), k_pos)
    elif layout == "shard":
        q_pos[-1, -(lq // 3):] = -1
        k_pos[src[:, 0] == p - 1, -(lk // 3):] = -1
    return q_pos.to(torch.int32), k_pos.to(torch.int32)


RING_DIMS = (16, 32, 64, 80, 120, 128, 256)


def ring_cases():
    """(label, P, B, Hkv, group, Lq, Lk, layout, step, kwargs); each runs
    at RING_DIMS in f32 and bf16."""
    causal = dict(causal=True)
    return [
        ("ring16", 16, 1, 2, 7, 64, 64, "ring", 5, causal),
        ("diag1", 1, 2, 2, 1, 100, 100, "ring", 0, causal),
        ("noncausal4", 4, 2, 2, 7, 37, 70, "ring", 1,
         dict(causal=False)),
        ("window4", 4, 2, 2, 1, 96, 96, "ring", 1,
         dict(causal=True, window=40)),
        ("softcap4", 4, 1, 2, 7, 50, 50, "ring", 3,
         dict(causal=True, softcap=30.0)),
        ("future4", 4, 2, 2, 1, 33, 65, "future", 0, causal),
        ("partly1", 1, 2, 2, 7, 64, 64, "partly", 0, causal),
        ("pad4", 4, 2, 2, 7, 40, 45, "pad", 1,
         dict(causal=True, window=30, softcap=50.0)),
        ("late4", 4, 1, 2, 7, 130, 200, "late", 0, causal),
        ("shard4", 4, 1, 2, 1, 150, 150, "shard", 1,
         dict(causal=True, window=100)),
    ]


def ring_over(torch, got, want, vmax) -> tuple[dict, int, int]:
    """({component: worst err/limit} of acc, m, l and their finalize, rows
    that keep a key, rows that keep none) under 8a's limits; a row that
    keeps none counts as inf under "masked" unless its m and l equal the
    plain version's exactly."""
    acc, m, l = got
    racc, rm, rl = want
    grow = math.sqrt(acc.shape[-1] / 16)
    kept = rm > NEG_INF
    none = ~kept
    exact = torch.equal(m[none], rm[none]) and torch.equal(l[none], rl[none])
    lim_acc = RING_ACC_TOL * (rl * vmax).clamp_min(1.0)[..., None]
    over = {"masked": 0.0 if exact else math.inf,
            "acc": ((acc - racc).abs() / lim_acc).max().item()}
    if kept.any():
        over["m"] = ((m - rm).abs()[kept]
                     / (grow * RING_M_RTOL * rm.abs()[kept].clamp_min(1.0))
                     ).max().item()
        over["l"] = ((l - rl).abs()[kept]
                     / (grow * RING_M_RTOL * rl[kept])).max().item()
    over["finalize"] = (acc / l.clamp_min(1e-30)[..., None]
                        - racc / rl.clamp_min(1e-30)[..., None]
                        ).abs().max().item() / (grow * RING_OUT_ATOL)
    return over, int(kept.sum()), int(none.sum())


def check_ring_partials(torch, ra, ref, gen) -> float:
    """8a: kernel 6 against `ref.ring_partials_ref` on the same inputs over
    ring_cases() x D x dtype; every case is checked and printed before a
    failure is raised.  Returns the worst err/limit."""
    worst, bad, rows = 0.0, [], [0, 0]
    for label, p, b, hkv, group, lq, lk, layout, step, kw in ring_cases():
        for d in RING_DIMS:
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                q, k, v = attention_inputs(torch, gen, p * b, hkv * group,
                                           hkv, lq, lk, d, dt)
                q, k, v = (x.reshape((p, b) + tuple(x.shape[1:]))
                           for x in (q, k, v))
                q_pos, k_pos = ring_positions(torch, gen, layout, p, lq, lk,
                                              step)
                got = ra.attn_block_partials(q, k, v, q_pos, k_pos, **kw)
                want = ref.ring_partials_ref(q, k, v, q_pos, k_pos, **kw)
                torch.cuda.synchronize()
                if any(g.shape != w.shape or g.dtype != torch.float32
                       or not torch.isfinite(g).all()
                       for g, w in zip(got, want)):
                    bad.append(f"{label} D{d} {dtype}: shape/dtype/finite")
                    continue
                parts, kept, none = ring_over(torch, got, want,
                                              v.float().abs().max().item())
                over = max(parts.values())
                rows[0] += kept
                rows[1] += none
                worst = max(worst, over)
                log(f"  ring partials {label:10s} D{d:<3d} {dtype:8s} P{p} "
                    f"B{b} Hq{hkv * group} Hkv{hkv} Lq{lq} Lk{lk} {layout} "
                    f"{kw}: err/limit "
                    + " ".join(f"{c} {x:.3f}" for c, x in parts.items())
                    + f"; rows keeping a key {kept}, keeping none {none}")
                if not over <= 1.0:
                    bad.append(f"{label} D{d} {dtype}: err/limit {over}")
    log(f"  kernel 6 vs plain: {len(ring_cases()) * len(RING_DIMS) * 2} "
        f"cases, worst "
        f"err/limit {worst:.3f}; rows keeping a key {rows[0]}, wholly "
        f"masked {rows[1]}")
    if bad or not (rows[0] and rows[1]):
        raise AssertionError(f"ring partials: {bad or rows}")
    return worst


def ring_block_counts(p, b, hq, hkv, lq, lk, d, itemsize, pairs):
    """(bytes, products-ops) of one partials call: q, k, v and both
    position tables read once, acc, m and l written once; 4 D operations
    for each kept query-key pair."""
    nbytes = (p * b * (hq * lq + 2 * hkv * lk) * d * itemsize
              + 4 * p * (lq + lk) + 4 * p * b * hq * lq * (d + 2))
    return nbytes, 4 * d * pairs * b * hq


def time_ring_partials(torch, ra, ref, gen, card) -> dict:
    """8b: kernel 6 at the ring step's shape (16 PEs, B 1, Hq 14, Hkv 2,
    Lq = Lk = 2048, D 64, bf16, causal) on three blocks: the diagonal one
    (each PE its own block, the ring's first step), one wholly kept (every
    key before every query) and one wholly masked (every key after every
    query).  Each: its C entry back to back, the wrapper, the plain
    version, and scaled_dot_product_attention over the same 16 PEs with
    the block's boolean mask (a yardstick of the work: it computes the
    normalised output, not (acc, m, l)), beside its own bound.  Returns
    the diagonal block's, with the others under their names."""
    import torch.nn.functional as F
    p, b, hq, hkv, lq, lk, d = 16, 1, 14, 2, 2048, 2048, 64
    dt = torch.bfloat16
    q, k, v = attention_inputs(torch, gen, p * b, hq, hkv, lq, lk, d, dt)
    q, k, v = (x.reshape((p, b) + tuple(x.shape[1:])) for x in (q, k, v))
    if not ra.tensor_core_route(q, k, v):
        raise AssertionError("kernel 6 at the ring step is not on the "
                             "tensor cores")
    scale = 1.0 / math.sqrt(d)
    lib = ra._library()
    stream = torch.cuda.current_stream().cuda_stream
    vsum = torch.empty((p * b * hkv, d), dtype=torch.float32, device="cuda")
    bounds = torch.empty((p, -(-lk // ra.BK), 4), dtype=torch.int32,
                         device="cuda")
    f32 = PEAK_OPS_PER_S["torch.float32"]
    got = {}
    for block, layout in (("diagonal", "ring"), ("kept", "kept"),
                          ("masked", "future")):
        q_pos, k_pos = ring_positions(torch, gen, layout, p, lq, lk, 0)
        res = ra.attn_block_partials(q, k, v, q_pos, k_pos, causal=True)
        want = ref.ring_partials_ref(q, k, v, q_pos, k_pos, causal=True)
        over = max(ring_over(torch, res, want,
                             v.float().abs().max().item())[0].values())
        err = max((g - w).abs().max().item() for g, w in zip(res, want))
        if not over <= 1.0:
            raise AssertionError(f"ring partials at the ring step, {block} "
                                 f"block: err/limit {over}")
        acc, m, l = res
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                k_pos.data_ptr(), acc.data_ptr(), m.data_ptr(),
                l.data_ptr(), vsum.data_ptr(), bounds.data_ptr(), 1, p, b,
                hq, hkv, lq, lk, d, 1, 0, 0.0, scale, stream)
        kernel_ms = time_ms(lambda: lib.repro_ring_partials(*args),
                            iters=20, warmup=3)
        wrapper_ms = time_ms(lambda: ra.attn_block_partials(
            q, k, v, q_pos, k_pos, causal=True), iters=20, warmup=3)
        plain_ms = time_ms(lambda: ref.ring_partials_ref(
            q, k, v, q_pos, k_pos, causal=True), iters=3, warmup=1)
        mask = (k_pos[:, None, :] <= q_pos[:, :, None])[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, 0], k[:, 0], v[:, 0], attn_mask=mask, scale=scale,
            enable_gqa=True)
        library_ms = time_ms(sdpa, iters=10, warmup=2)
        pairs = int(mask.sum().item())
        if pairs:
            nbytes, ops_count = ring_block_counts(p, b, hq, hkv, lq, lk, d,
                                                  2, pairs)
            sdpa_err = (sdpa().float() - (acc / l[..., None])[:, 0]
                        ).abs().max().item()
        else:
            # no kept pair: the function needs v (its sum), the positions,
            # and writes acc, m and l; q and k are never read
            nbytes = (p * b * hkv * lk * d * 2 + 4 * p * (lq + lk)
                      + 4 * p * b * hq * lq * (d + 2))
            ops_count, sdpa_err = 0, float("nan")
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_count / PEAK_OPS_PER_S[str(dt)] * 1e3
        bound = max(t_bytes, t_ops)
        log(f"  times at P{p} B{b} Hq{hq} Hkv{hkv} Lq{lq} Lk{lk} D{d} bf16 "
            f"causal, {block} block ({card}): kernel {kernel_ms:.5f} ms, "
            f"wrapper {wrapper_ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa "
            f"with the block mask {library_ms:.5f} ms (sdpa max|err| vs the "
            f"kernel's acc/l {sdpa_err:.3e}); max|err| vs plain {err:.3e}; "
            f"bound {bound:.6f} ms by {'bytes' if t_bytes >= t_ops else 'operations'} "
            f"({nbytes} B = {t_bytes:.6f} ms; {ops_count} products-ops of "
            f"the {pairs} kept pairs = {t_ops:.6f} ms at the bf16 "
            f"tensor-core rate, {ops_count / f32 * 1e3:.6f} ms at the f32 "
            f"rate); kernel at {bound / kernel_ms:.1%} of its bound")
        got[block] = dict(max_abs_err=err, ms=kernel_ms,
                          wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound,
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations")
        del acc, m, l, res, want, mask
    every = 4 * d * p * b * hq * lq * lk
    log(f"  the causal ring of {p} steps holds {p} diagonal, "
        f"{p * (p - 1) // 2} kept and {p * (p - 1) // 2} masked PE-blocks; "
        f"computing every tile of every block, as the TPU kernel does, "
        f"would be {p * every} ops")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(got["diagonal"], kept=got["kept"], masked=got["masked"])


def _shard_seq(x, n):
    """(B, H, L, D) -> (n, B, H, L/n, D), contiguous: PE p holds rows
    [p L/n, (p+1) L/n)."""
    b, h, length, d = x.shape
    return x.reshape(b, h, n, length // n, d).permute(2, 0, 1, 3, 4) \
        .contiguous()


def _unshard_seq(x):
    n, b, h, ls, d = x.shape
    return x.permute(1, 2, 0, 3, 4).reshape(b, h, n * ls, d)


def bf16_over(torch, got, want) -> float:
    """Worst |got - want| over the larger of 2e-5 and one step of want's
    dtype at |want| (phase 2's rule)."""
    diff = (got.float() - want.float()).abs()
    limit = torch.maximum(torch.full_like(diff, RING_OUT_ATOL),
                          ulp(torch, want))
    return (diff / limit).max().item()


def ring_path(torch, np, serving, ra, ref, ops, fa, card) -> list:
    """8c: qwen2-0.5b's layer-0 q, k, v (seeded weights, bf16, after the
    projections and RoPE) over RING_RUN's 32768-token prompt, sharded over
    16 PEs, through fusion.ring_attention on the plain and the NoC SIM:
    16 kernel-6 launches and 3 x 15 puts each; the output against kernel
    4 over the gathered sequence and against the same ring through the
    plain partials; the mono alternative (fcollect of k and v, then
    kernel 4) timed; the merged f32 (acc, m, l) of the kernel ring and the
    plain-partials ring held to each other under 8a's limits; then a
    window of 4096 and a softcap of 50.  Returns the launch counts of
    each run."""
    from repro_torch.core import abmodel, fusion, sim_ctx
    from repro_torch.core import collectives as coll
    from repro_torch.core.pattern import ring_pattern
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.parallel.comm import Comm
    cfg, run = serving.CONFIG, serving.RING_RUN
    n, topo, seq = run["n_pes"], run["topology"], run["seq_len"]
    params = transformer.init_params(cfg, seed=0, device="cuda")
    bp = params["layers"][run["layer"]]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, size=(run["batch"], seq)), device="cuda")
    positions = torch.arange(seq, device="cuda").expand(run["batch"], seq)
    with torch.no_grad():
        h = L.rms_norm(L.embed(Comm(), cfg, params["embed"], tokens),
                       bp["ln1"])
        q, k, v = L.attention_qkv(cfg, bp["attn"], h, positions)
    del params, h
    qs, ks, vs = (_shard_seq(x, n) for x in (q, k, v))
    pos = torch.arange(seq, dtype=torch.int32, device="cuda").reshape(n, -1)
    waves = len(ring_pattern(n).link_waves(topo))
    counts, outs, walls = [], {}, {}

    def ring(noc, **kw):
        ctx = sim_ctx(n, topo, noc=noc, device="cuda")
        torch.cuda.synchronize()
        _reset_counts()                                 # path starts
        t0 = time.perf_counter()
        out = fusion.ring_attention(ctx, qs, ks, vs, pos, pos, causal=True,
                                    **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts()                                 # path ends
        want = {"flash_attention": 0, "put_copy": 3 * (n - 1),
                "dma_copy": 0, "fused_update": 0, "ssd_scan": 0,
                "reduce_combine": 3 * (n - 1) if noc and waves > 1 else 0,
                "ring_attention": n}
        if got != want:
            raise AssertionError(f"ring noc={noc} {kw}: launches {got}, the "
                                 f"code implies {want}")
        counts.append(got)
        return out, wall

    def plain_partials(q_, k_, v_, qp_, kp_, **kw):
        return ref.ring_partials_ref(q_, k_, v_, qp_, kp_, **kw)

    kernel_partials, real_finalize = ra.attn_block_partials, ra.finalize

    def ring_through(partials, **kw):
        """The ring on the plain SIM with `partials` in kernel 6's place:
        (its output, the merged (acc, m, l) it hands to finalize)."""
        seen = []

        def capture(state, dtype=None):
            seen.append(state)
            return real_finalize(state, dtype)

        with mock.patch.object(ra, "attn_block_partials", partials), \
                mock.patch.object(ra, "finalize", capture):
            out = fusion.ring_attention(ctx, qs, ks, vs, pos, pos,
                                        causal=True, **kw)
        return _unshard_seq(out), seen[0]

    def states_over(**kw):
        """8a's limits (ring_over) on the merged states of the ring
        through kernel 6 and through the plain partials: the f32 check of
        the full-size ring that one bf16 step of the output cannot make.
        Returns (the plain ring's output, {component: err/limit})."""
        _, got = ring_through(kernel_partials, **kw)
        plain, want = ring_through(plain_partials, **kw)
        parts, _, none = ring_over(torch, got, want,
                                   vs.float().abs().max().item())
        if none or not all(torch.isfinite(x).all() for x in got):
            raise AssertionError(f"ring {kw}: {none} rows keep no key, or "
                                 f"the merged state is not finite")
        return plain, parts

    torch.cuda.reset_peak_memory_stats()
    for noc in (False, True):
        outs[noc], walls[f"ring noc={noc}"] = ring(noc)
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(outs[False], outs[True]):
        raise AssertionError("ring on the NoC SIM != ring on the plain SIM")
    # mono: fcollect of k and v (each PE then holds the whole sequence),
    # then kernel 4 over the gathered sequence: every PE's query rows in
    # one launch against PE 0's copy (all copies are equal)
    ctx = sim_ctx(n, topo, device="cuda")
    torch.cuda.synchronize()
    _reset_counts()                                     # mono starts
    t0 = time.perf_counter()
    kf = ctx.fcollect(ks, axis=2)
    vf = ctx.fcollect(vs, axis=2)
    mono = ops.attention(q, kf[0], vf[0], causal=True)
    torch.cuda.synchronize()
    walls["mono"] = time.perf_counter() - t0
    mono_counts = _counts()                             # mono ends
    stages = len(coll.fcollect_schedule(n, 0.0, "rd").stages)
    want = dict({name: 0 for name in mono_counts}, put_copy=2 * stages,
                dma_copy=2, flash_attention=1)
    if mono_counts != want or not (torch.equal(kf[0], k)
                                   and torch.equal(vf[0], v)):
        raise AssertionError(f"mono: launches {mono_counts} (want {want}) "
                             f"or fcollect is not the sequence")
    counts.append(mono_counts)
    got = _unshard_seq(outs[False])
    over_mono = bf16_over(torch, got, mono)
    plain, states = states_over()
    over_plain = bf16_over(torch, got, plain)
    log(f"  ring over {n} PEs ({topo.shape} mesh, {waves} NoC waves per "
        f"rotation) of {cfg.name} layer {run['layer']}'s q {tuple(q.shape)}"
        f" k {tuple(k.shape)} bf16, causal: err/limit vs kernel 4 on the "
        f"gathered sequence {over_mono:.3f}, vs the ring through the plain "
        f"partials {over_plain:.3f} (limit max(2e-5, 1 bf16 step)); merged "
        f"f32 states vs the plain-partials ring under 8a's limits: "
        + " ".join(f"{c} {x:.3f}" for c, x in states.items())
        + f"; NoC ring == plain-SIM ring bit for bit; launches {counts[0]} "
        f"(plain SIM), {counts[1]} (NoC), mono {mono_counts}")
    if not (over_mono <= 1.0 and over_plain <= 1.0
            and max(states.values()) <= 1.0):
        raise AssertionError(f"ring output: err/limit {over_mono} vs mono, "
                             f"{over_plain} vs plain partials, merged "
                             f"states {states}")
    # gemma2-9b's local window and attention softcap on qwen2's geometry
    kw = dict(window=4096, softcap=50.0)
    out, walls["ring window+softcap"] = ring(False, **kw)
    got = _unshard_seq(out)
    mono_ws = ops.attention(q, k, v, causal=True, **kw)
    plain, states = states_over(**kw)
    over_ws = (bf16_over(torch, got, mono_ws), bf16_over(torch, got, plain))
    log(f"  ring with window 4096 and softcap 50: err/limit vs kernel 4 "
        f"{over_ws[0]:.3f}, vs the plain partials {over_ws[1]:.3f}; merged "
        f"f32 states under 8a's limits: "
        + " ".join(f"{c} {x:.3f}" for c, x in states.items())
        + f"; launches {counts[-1]}")
    if not (max(over_ws) <= 1.0 and max(states.values()) <= 1.0):
        raise AssertionError(f"ring window+softcap: err/limit {over_ws}, "
                             f"merged states {states}")
    # kernel 4 alone at the gathered shape (row 4's long reading)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    lib = fa._library()
    b, hq, _, d = q.shape
    args = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), mono.data_ptr(), 1,
            b, hq, k.shape[1], seq, seq, d, d, seq, 1, 0, 0.0,
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    k4_ms = time_ms(lambda: lib.repro_flash_attention_fwd(*args), iters=3,
                    warmup=1)
    # SDPA at the same shape: a yardstick the port never calls, on a fused
    # backend only (the math backend would form 60 GB of logits)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True)

    with sdpa_kernel(fused):
        sdpa_diff = (sdpa().float() - mono.float()).abs().max().item()
        sdpa_ms = time_ms(sdpa, iters=3, warmup=1)
    pairs = seq * (seq + 1) // 2
    k4_bytes = (2 * qc.numel() + kc.numel() + vc.numel()) * 2
    k4_ops = 4 * d * pairs * b * hq
    k4_bound = max(k4_bytes / HBM_BYTES_PER_S, k4_ops /
                   PEAK_OPS_PER_S["torch.bfloat16"]) * 1e3
    # choose_attention at the measured per-block time, t_mono / n, as
    # benchmarks/bench_fused.py reckons it
    kv_bytes = (ks[0].numel() + vs[0].numel()) * ks.element_size() \
        + pos[0].numel() * pos.element_size()
    picks = {"default link": fusion.choose_attention(
        n, kv_bytes, walls["mono"] / n),
        "epiphany16 board": fusion.choose_attention(
            n, kv_bytes, walls["mono"] / n, topo=topo,
            link=abmodel.EPIPHANY_NOC)}
    log(f"  walls ({card}; host clock, ending in synchronize): "
        + ", ".join(f"{name} {w * 1e3:.3f} ms" for name, w in walls.items())
        + f"; peak device memory of the two rings {peak / 2**30:.3f} GiB")
    log(f"  kernel 4 at B{b} Hq{hq} Hkv{k.shape[1]} L{seq} D{d} bf16 causal "
        f"(the gathered sequence; {card}): {k4_ms:.5f} ms; bound "
        f"{k4_bound:.6f} ms "
        f"({k4_bytes} B, {k4_ops} ops of the {pairs} kept pairs at the "
        f"bf16 rate; {k4_ops / PEAK_OPS_PER_S['torch.float32'] * 1e3:.6f} "
        f"ms at the f32 rate); scaled_dot_product_attention (causal, "
        f"enable_gqa, fused backends) {sdpa_ms:.5f} ms, max|diff| vs "
        f"kernel 4 {sdpa_diff:.3e}")
    log(f"  choose_attention(n={n}, kv_block_bytes={kv_bytes}, "
        f"block_compute_s=t_mono/{n}={walls['mono'] / n:.6f}): "
        + "; ".join(f"{where}: pick {pick}, modeled ring "
                    f"{times['ring'] * 1e3:.6f} ms, mono "
                    f"{times['mono'] * 1e3:.6f} ms"
                    for where, (pick, times) in picks.items()))
    del q, k, v, qs, ks, vs, kf, vf, mono, mono_ws, plain, outs, qc, kc, vc
    torch.cuda.empty_cache()
    return counts, {"n": n, "topo": topo, "kv_bytes": kv_bytes,
                    "block_s": walls["mono"] / n,
                    "ring_s": walls["ring noc=False"],
                    "mono_s": walls["mono"]}


# ---------------------------------------------------------------------------
# phase 9: serve zamba2-1.2b at full width — kernels 4 and 7, prefill, decode
# ---------------------------------------------------------------------------

# the f32 prefill's last-position logits through kernels 4 and 7 against
# those through their plain versions, relative to the largest logit: the
# limit of MAMBA_F32_LOGITS_RTOL, for the same reason.  zamba2 stacks 38
# Mamba2 layers, fewer than the 64 of the probe behind that limit (f32
# logits moved by 4.8e-4 of the largest at 64 layers), and its 7 shared
# attention blocks add kernel 4's f32 difference from the plain version,
# within 3e-5 of the output (phase 2's f32 limit), at each application
ZAMBA_F32_LOGITS_RTOL = MAMBA_F32_LOGITS_RTOL
# the plain attention over a 32768-token prompt is built this many query
# rows at a time, for up to 32 heads (proportionally fewer for more): the
# f32 logits of all rows at once would be 137 GB at zamba2's 32 heads,
# those of one block of rows at most 4.3 GB
PLAIN_ROWS = 1024
# kernel 4 at zamba2's attention shape (B, heads, L, D): 32 q heads over
# 32 KV heads (a group of 1), bf16, causal; held at 4096 tokens, timed at
# the prefill's 32768
ZAMBA_ATTN = (1, 32, 4096, 64)


def zamba_ssd_cases():
    """Kernel 7 at zamba2's head shape (H 64, P 64, N 64, chunk 128; the
    model's A and dt draws), contiguous and as the strided views `mamba2`
    hands over, in f32 and bf16 (ssd_cases' tuples)."""
    cases = []
    for dtype, scale in (("float32", 0.3), ("bfloat16", 1.0)):
        cases.append(("zamba_L4096", 1, 4096, 64, 64, 64, 1, 128, dtype,
                      dict(scale=scale, model=True)))
        cases.append(("zamba_strided", 1, 1024, 64, 64, 64, 1, 128, dtype,
                      dict(scale=scale, model=True, strided=True)))
    return cases


def blockwise_attention(torch, ref, ra, q, k, v, *, causal=True,
                        window=None, softcap=None, sm_scale=None,
                        lk_valid=None):
    """The plain attention of q (B, Hq, Lq, D) over k, v (kernel 4's
    function, query row i at position i and key j at j), built PLAIN_ROWS
    query rows at a time (fewer above 32 heads): `ref.ring_partials_ref`
    of the block against the keys up to its last row (a causal row keeps
    none past itself) and, under a window, from its first row's first
    kept key on, by global positions, keys at or past `lk_valid` marked
    -1, then `finalize` in q's dtype.  Its probabilities stay in f32."""
    lq, lk = q.shape[2], k.shape[2]
    lk_valid = lk if lk_valid is None else lk_valid
    rows = PLAIN_ROWS * 32 // max(32, q.shape[1])
    pos = torch.arange(max(lq, lk), dtype=torch.int32, device=q.device)
    k_pos = torch.where(pos[:lk] < lk_valid, pos[:lk], -1)
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                      device=q.device)
    for r0 in range(0, lq, rows):
        r1 = min(lq, r0 + rows)
        hi = min(lk, r1) if causal else lk
        lo = max(0, r0 - window + 1) if window is not None else 0
        state = ref.ring_partials_ref(
            q[:, :, r0:r1], k[:, :, lo:hi], v[:, :, lo:hi], pos[r0:r1],
            k_pos[lo:hi], causal=causal, window=window, softcap=softcap,
            sm_scale=sm_scale)
        out[:, :, r0:r1] = ra.finalize(state, q.dtype)
        del state
    return out


def check_zamba_kernels(torch, ops, ref, fa, ra, gen) -> None:
    """9a: kernel 7 at zamba2's head shape (zamba_ssd_cases, each phase
    on its own inputs, as 7a), and kernel 4 at ZAMBA_ATTN against
    `ref.attention_ref` (phase 2's limits) and against
    `blockwise_attention`, the plain version 9c holds it to at 32768
    tokens."""
    worst, worst_phase = check_ssd_cases(torch, ops, ref, gen,
                                         zamba_ssd_cases())
    log(f"  ssd at zamba2's H 64, P 64, N 64: worst err/limit of y and the "
        f"state {worst:.3f}, of the phases {worst_phase:.3f}")
    b, h, seq, d = ZAMBA_ATTN
    dt = torch.bfloat16
    q, k, v = attention_inputs(torch, gen, b, h, h, seq, seq, d, dt)
    out = ops.attention(q, k, v, causal=True)
    want = plain_attention(torch, ref, q, k, v, causal=True)
    blocks = blockwise_attention(torch, ref, ra, q, k, v, causal=True)
    torch.cuda.synchronize()
    err, over = attention_over(torch, out, want, dt)
    err_b, over_b = attention_over(torch, out, blocks, dt)
    gap = (blocks.float() - want.float()).abs().max().item()
    route = "tensor cores" if fa.tensor_core_route(q, k, v) \
        else "CUDA cores"
    typical = want.float().abs().mean().item()
    log(f"  attention zamba2 B{b} Hq{h} Hkv{h} L{seq} D{d} bf16 causal "
        f"({route}): vs attention_ref max|err| {err:.3e} (worst err/limit "
        f"{over:.3f}), vs the blockwise plain version {err_b:.3e} "
        f"({over_b:.3f}); blockwise vs attention_ref {gap:.3e} (f32 against "
        f"bf16 probabilities); mean|out| {typical:.3f}")
    if route != "tensor cores":
        raise AssertionError("kernel 4 at zamba2's shape did not take the "
                             "tensor cores")
    if not (over <= 1.0 and over_b <= 1.0 and torch.isfinite(out).all()):
        raise AssertionError(f"kernel 4 at zamba2's shape: err/limit {over}"
                             f" vs attention_ref, {over_b} vs blockwise")
    if not typical > 10 * TOL[str(dt)]:
        raise AssertionError(f"kernel 4 at zamba2's shape: mean|out| "
                             f"{typical} is not far above the tolerance")
    del q, k, v, out, want, blocks
    torch.cuda.empty_cache()


def time_zamba_attention(torch, fa, ref, ra, gen, card, seq) -> dict:
    """9b: kernel 4 at the zamba2 prefill's attention shape (B 1, Hq =
    Hkv = 32, L `seq`, D 64, bf16, causal): its C entry back to back,
    the blockwise plain version once, and scaled_dot_product_attention on
    a fused backend (a yardstick the port never calls)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    b, h, _, d = ZAMBA_ATTN
    dt = torch.bfloat16
    q, k, v = attention_inputs(torch, gen, b, h, h, seq, seq, d, dt)
    scale = 1.0 / math.sqrt(d)
    out = fa.flash_attention(q, k, v, causal=True, sm_scale=scale)
    lib = fa._library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b,
            h, h, seq, seq, d, d, seq, 1, 0, 0.0, scale,
            torch.cuda.current_stream().cuda_stream)
    kernel_ms = time_ms(lambda: lib.repro_flash_attention_fwd(*args),
                        iters=5, warmup=1)
    plain = blockwise_attention(torch, ref, ra, q, k, v, causal=True,
                                sm_scale=scale)
    err, over = attention_over(torch, out, plain, dt)
    plain_ms = time_ms(lambda: blockwise_attention(
        torch, ref, ra, q, k, v, causal=True, sm_scale=scale), iters=1,
        warmup=0)
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)

    with sdpa_kernel(fused):
        sdpa_diff = (sdpa().float() - out.float()).abs().max().item()
        library_ms = time_ms(sdpa, iters=5, warmup=1)
    pairs = seq * (seq + 1) // 2
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
        * q.element_size()
    ops_count = 4 * d * pairs * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS_PER_S[str(dt)] * 1e3
    log(f"  kernel 4 at B{b} Hq{h} Hkv{h} L{seq} D{d} bf16 causal ({card}): "
        f"{kernel_ms:.5f} ms; blockwise plain {plain_ms:.5f} ms (max|err| vs "
        f"it {err:.3e}, err/limit {over:.3f}); scaled_dot_product_attention "
        f"(causal, fused backends) {library_ms:.5f} ms, max|diff| vs kernel 4"
        f" {sdpa_diff:.3e}; bound {max(t_bytes, t_ops):.6f} ms ({nbytes} B, "
        f"{ops_count} ops of the {pairs} kept pairs at the bf16 rate); "
        f"kernel / sdpa {kernel_ms / library_ms:.3f}")
    if not over <= 1.0:
        raise AssertionError(f"kernel 4 at L{seq}: err/limit {over}")
    del q, k, v, out, plain
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def serve_zamba(torch, np, zamba, ops, ref, ra) -> dict:
    """9c: build_prefill on zamba2-1.2b at full width (seeded random
    weights, bf16 compute on f32 weights) over SERVE_RUN's prompt: 38
    ssd_scan and 7 flash_attention launches and finite logits.  Then the
    same prefill through the plain versions, kernel 7 held to
    `ref.ssd_chunked_ref` in every layer and kernel 4 to
    `blockwise_attention` on every query row of each of its 7 calls, each
    on that call's inputs; then the prefill in f32 compute through the
    kernels and through the plain versions, its logits within
    ZAMBA_F32_LOGITS_RTOL of the largest.  Returns the launch counts of
    the path."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    cfg, run = zamba.CONFIG, zamba.SERVE_RUN
    params = transformer.init_params(cfg, seed=0, device="cuda")
    n_params = sum(w.numel() for w in tree_flatten(params)[0])
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(
        1, cfg.vocab, size=(run["prefill_batch"], run["prefill_len"])),
        device="cuda")
    prefill = sstep.build_prefill(cfg)
    n_shared = transformer.n_shared_blocks(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                                  # path starts
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()                               # path ends
    peak = torch.cuda.max_memory_allocated()
    log(f"  prefill {cfg.name} ({n_params} parameters, {cfg.n_layers} "
        f"Mamba2 layers and {n_shared} applications of the shared attention"
        f" block, d {cfg.d_model}, vocab {cfg.vocab}), batch "
        f"{run['prefill_batch']} x L {run['prefill_len']}: wall {wall:.3f} s "
        f"({run['prefill_batch'] * run['prefill_len'] / wall:.1f} prompt "
        f"tok/s), peak memory {peak / 2**30:.3f} GiB, launches {counts}")
    want = dict({name: 0 for name in counts}, ssd_scan=cfg.n_layers,
                flash_attention=n_shared)
    if counts != want:
        raise AssertionError(f"prefill launches {counts}, want {want}")
    if logits.shape != (run["prefill_batch"], 1, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    # the same prefill through the plain versions; each kernel call's
    # output on that call's inputs held to the plain output
    kernel_scan, kernel_attn = ops._ssd.ssd_scan, ops._fa.flash_attention
    ssd_over_, attn_over, attn_rows = [], [], []

    def ssd_both(x, dt, a, bm, cm, h0=None, *, chunk):
        want = ref.ssd_chunked_ref(x, dt, a, bm, cm, h0, chunk=chunk)
        got = kernel_scan(x, dt, a, bm, cm, h0, chunk=chunk)
        ssd_over_.append(ssd_over(torch, *got, *want)[0])
        return want

    def attn_both(q, k, v, **kw):
        got = kernel_attn(q, k, v, **kw)
        want = blockwise_attention(torch, ref, ra, q, k, v, **kw)
        attn_over.append(attention_over(torch, got, want, q.dtype)[1])
        attn_rows.append(q.shape[2])
        return want

    t0 = time.perf_counter()
    with mock.patch.object(ops._ssd, "ssd_scan", ssd_both), \
            mock.patch.object(ops._fa, "flash_attention", attn_both):
        plain = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    both_wall = time.perf_counter() - t0
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  in the bf16 prefill, on each call's inputs: kernel 7 vs plain "
        f"in {len(ssd_over_)} layers, worst err/limit {max(ssd_over_):.3f}; "
        f"kernel 4 vs the blockwise plain version in {len(attn_over)} calls"
        f" of {attn_rows} query rows, worst err/limit {max(attn_over):.3f} "
        f"(per call: " + " ".join(f"{x:.3f}" for x in attn_over)
        + f"); plain + kernel prefill wall {both_wall:.3f} s")
    log(f"  bf16 prefill logits, kernel path vs plain path (not gated, see "
        f"ZAMBA_F32_LOGITS_RTOL): max|err| {err:.4e}, max|logit| "
        f"{scale:.4f}, {err / scale / 2.0 ** -8:.2f} bf16 ulps of the "
        f"largest; argmax {int(logits.argmax())} vs {int(plain.argmax())}")
    if len(ssd_over_) != cfg.n_layers or not max(ssd_over_) <= 1.0:
        raise AssertionError(f"kernel 7 in the prefill's layers: {ssd_over_}")
    rows = -(-run["prefill_len"] // ops._fa.BQ) * ops._fa.BQ   # padded
    if attn_rows != [rows] * n_shared \
            or not max(attn_over) <= 1.0:
        raise AssertionError(f"kernel 4 in the prefill's shared blocks: "
                             f"rows {attn_rows}, err/limit {attn_over}")
    del logits, plain
    torch.cuda.empty_cache()
    prefill32 = sstep.build_prefill(dataclasses.replace(cfg,
                                                        dtype=torch.float32))
    t0 = time.perf_counter()
    logits = prefill32(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0

    def attn_plain(q, k, v, **kw):
        return blockwise_attention(torch, ref, ra, q, k, v, **kw)

    with mock.patch.object(ops._ssd, "ssd_scan", ref.ssd_chunked_ref), \
            mock.patch.object(ops._fa, "flash_attention", attn_plain):
        plain = prefill32(params, {"tokens": tokens})
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  f32 prefill logits, kernel path vs plain path: max|err| "
        f"{err:.4e}, max|logit| {scale:.4f}, rel {err / scale:.3e} (tol "
        f"{ZAMBA_F32_LOGITS_RTOL}); argmax {int(logits.argmax())} vs "
        f"{int(plain.argmax())}; kernel-path wall {wall32:.3f} s")
    if not (torch.isfinite(logits).all()
            and err <= ZAMBA_F32_LOGITS_RTOL * scale):
        raise AssertionError(f"f32 prefill logits differ by {err} "
                             f"(max|logit| {scale})")
    del logits, plain, tokens, params
    torch.cuda.empty_cache()
    return counts


def decode_f32_vs_prefill(torch, np, zamba) -> None:
    """9d, gated: in bf16 the loop's logits cannot be held to the
    prefill's (a random-weight stack amplifies each flipped bf16 rounding,
    see MAMBA_F32_LOGITS_RTOL; 7d and 9d print that difference).  So the
    decode path is held in f32 compute: SERVE_RUN's prompts fed through
    build_decode_step against caches of --cache-len slots, the logits at
    the last prompt position against build_prefill's (kernels 4 and 7)
    within ZAMBA_F32_LOGITS_RTOL of the largest."""
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    run = zamba.SERVE_RUN
    cfg = dataclasses.replace(zamba.CONFIG, dtype=torch.float32)
    B, prompt_len = run["batch"], run["prompt_len"]
    params = transformer.init_params(cfg, seed=0, device="cuda")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, size=(B, prompt_len)), device="cuda")
    cache = transformer.init_cache(cfg, 1, B, run["cache_len"],
                                   device="cuda")
    decode = sstep.build_decode_step(cfg)
    for t in range(prompt_len):
        logits, cache = decode(params, cache, {
            "tokens": prompts[:, t:t + 1],
            "positions": torch.full((B,), t, device="cuda")})
    pre = sstep.build_prefill(cfg)(params, {"tokens": prompts})
    err = (logits - pre).abs().max().item()
    scale = pre.abs().max().item()
    log(f"  f32 decode ({prompt_len} steps, batch {B}, caches of "
        f"{run['cache_len']} slots) vs the f32 prefill at the last prompt "
        f"position: max|err| {err:.4e}, max|logit| {scale:.4f}, rel "
        f"{err / scale:.3e} (tol {ZAMBA_F32_LOGITS_RTOL})")
    if not (torch.isfinite(logits).all()
            and err <= ZAMBA_F32_LOGITS_RTOL * scale):
        raise AssertionError(f"f32 decode logits differ from the prefill's "
                             f"by {err} (max|logit| {scale})")
    del params, cache
    torch.cuda.empty_cache()


def long_decode(torch, np, zamba) -> None:
    """9e: one build_decode_step of zamba2-1.2b at SERVE_RUN's long
    decode (batch 4 against caches of 32768 slots, every cache filled
    from a seeded generator) at position 32767: finite logits, each
    shared attention cache changed at slot 32767 of every row and nowhere
    else; then the wall of a few more steps and the peak memory."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    cfg, run = zamba.CONFIG, zamba.SERVE_RUN
    B, S = run["long_batch"], run["long_cache_len"]
    params = transformer.init_params(cfg, seed=0, device="cuda")
    cache = transformer.init_cache(cfg, 1, B, S, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for leaf in tree_flatten(cache)[0]:
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    before = [{k: c[k].clone() for k in ("k", "v")} for c in cache["shared"]]
    decode = sstep.build_decode_step(cfg)
    batch = {"tokens": torch.randint(1, cfg.vocab, (B, 1), generator=gen,
                                     device="cuda"),
             "positions": torch.full((B,), S - 1, device="cuda")}
    nbytes = sum(c[k].numel() * c[k].element_size()
                 for c in cache["shared"] for k in ("k", "v"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    logits, cache = decode(params, cache, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    changed = []
    for c, old in zip(cache["shared"], before):
        moved = torch.zeros((B, S), dtype=torch.bool, device="cuda")
        for k in ("k", "v"):
            moved |= (c[k] != old[k]).flatten(2).any(-1)
        changed.append(moved.nonzero()[:, 1].unique().tolist()
                       + [int(moved[:, S - 1].sum())])
    del before
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        logits_n, cache = decode(params, cache, batch)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / steps
    log(f"  long decode {cfg.name}: batch {B}, {len(cache['shared'])} shared"
        f" caches of {S} slots ({nbytes / 1e9:.3f} GB), position {S - 1}: "
        f"first step {first * 1e3:.3f} ms, then {per_step * 1e3:.3f} ms a "
        f"step over {steps}; peak memory {peak / 2**30:.3f} GiB; launches "
        f"{counts}; slots changed per shared cache [slots..., rows at "
        f"{S - 1}] {changed[0]} (each of {len(changed)})")
    if any(c != [S - 1, B] for c in changed):
        raise AssertionError(f"the decode step changed slots {changed}, "
                             f"want only {S - 1} in every row")
    if logits.shape != (B, 1, cfg.vocab) or not (
            torch.isfinite(logits).all() and torch.isfinite(logits_n).all()):
        raise AssertionError(f"long-decode logits {tuple(logits.shape)} are "
                             f"not finite")
    del params, cache, logits, logits_n
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: the rest of the dense family at full width — kernel 4 at head
# dims 256, 120 and 128; gemma2-9b, h2o-danube-3-4b, internlm2-20b
# ---------------------------------------------------------------------------

# kernel 4 held at its new shapes over this many tokens (10a), where a
# window of 4096 would keep every causal key: it is cut to 1024 there
# (phase 2's rule), and held at its real width over 32768 tokens, call by
# call, in 10b and 10d
DENSE_CHECK_LEN, DENSE_CHECK_WINDOW = 4096, 1024
# gemma2's prefill in f32 compute through the kernels and through the
# plain versions, logits within this share of the largest (the limit of
# MAMBA_F32_LOGITS_RTOL), over the first GEMMA_F32_LEN tokens of the
# prompt: at 32768 tokens the f32 projections alone (~600 TFLOP of
# products at the 67 TFLOP/s f32 rate, no TF32) would take ~10 s a pass,
# two passes plus f32 attention over a minute of the phase's ~400 s.
# 8192 tokens still hold two windows of 4096 on every local layer
DENSE_F32_LOGITS_RTOL = MAMBA_F32_LOGITS_RTOL
GEMMA_F32_LEN = 8192


def reference_windows(cfg) -> list:
    """Each layer's window by the reference's rule (`repro/models/
    layers.py:220-222`: the local window on the even layers of a
    local/global config, else cfg.window), written out apart from the
    port's own rule so that the launches are held to it."""
    return [cfg.local_window if cfg.local_global_period and i % 2 == 0
            else cfg.window for i in range(cfg.n_layers)]


def dense_attention_shapes(archs) -> list:
    """(label, Hq, Hkv, D, Dv, window, softcap, launches in one prefill,
    causal) of each kind of kernel-4 call the three models' prefills
    make: gemma2's local and global layers, danube's windowed and
    internlm2's causal ones."""
    shapes = []
    for mod in archs:
        cfg = mod.CONFIG
        windows = reference_windows(cfg)
        for window in dict.fromkeys(windows):
            kind = ("" if not cfg.local_global_period
                    else " local" if window else " global")
            shapes.append((cfg.name + kind, cfg.n_heads, cfg.n_kv_heads,
                           cfg.hd, cfg.hd, window, cfg.softcap,
                           windows.count(window), cfg.causal))
    return shapes


def check_dense_kernels(torch, ops, ref, fa, ra, gen, shapes) -> None:
    """10a, 11a, 12a, 13a: kernel 4 at each shape of
    `dense_attention_shapes`, `moe_attention_shapes` or
    `frontend_attention_shapes` (B 1, its heads and head dims, causal or
    not, its softcap, its window cut to DENSE_CHECK_WINDOW) over
    DENSE_CHECK_LEN tokens, bf16 and f32, against `plain_attention`
    (phase 2's limits; f32 against the f64 evaluation) and against
    `blockwise_attention`, the plain version 10b and 10d hold it to (in
    bf16; in f32 that version's own f32 products err by ~3e-5 at D 256,
    see `plain_attention`, so its gap is printed)."""
    seq = DENSE_CHECK_LEN
    for label, hq, hkv, d, dv, window, softcap, _, causal in shapes:
        kw = dict(causal=causal, softcap=softcap,
                  window=DENSE_CHECK_WINDOW if window else None)
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(torch, gen, 1, hq, hkv, seq, seq, d,
                                       dt, dv)
            out = ops.attention(q, k, v, **kw)
            want = plain_attention(torch, ref, q, k, v, **kw)
            blocks = blockwise_attention(torch, ref, ra, q, k, v, **kw)
            torch.cuda.synchronize()
            err, over = attention_over(torch, out, want, dt)
            err_b, over_b = attention_over(torch, out, blocks, dt)
            route = "tensor cores" if fa.tensor_core_route(q, k, v) \
                else "CUDA cores"
            typical = want.float().abs().mean().item()
            log(f"  attention {label} B1 Hq{hq} Hkv{hkv} L{seq} D{d} Dv{dv} "
                f"{dt} {kw} ({route}): vs attention_ref max|err| {err:.3e} "
                f"(worst err/limit {over:.3f}), vs the blockwise plain "
                f"version {err_b:.3e} ({over_b:.3f}); mean|out| "
                f"{typical:.3f}")
            if dt == torch.bfloat16 and route != "tensor cores":
                raise AssertionError(f"kernel 4 at {label}'s shape did not "
                                     f"take the tensor cores")
            if not (over <= 1.0 and torch.isfinite(out).all()) \
                    or (dt == torch.bfloat16 and not over_b <= 1.0):
                raise AssertionError(f"kernel 4 at {label} {dt}: err/limit "
                                     f"{over} vs attention_ref, {over_b} "
                                     f"vs blockwise")
            if not typical > 10 * TOL[str(dt)]:
                raise AssertionError(f"kernel 4 at {label}: mean|out| "
                                     f"{typical} is not far above the "
                                     f"tolerance")
            del q, k, v, out, want, blocks
            torch.cuda.empty_cache()


def window_mask(torch, seq, window):
    """The additive (L, L) bf16 mask of a causal window: 0 where key j
    is kept by row i (i - window < j <= i), -inf elsewhere."""
    i = torch.arange(seq, device="cuda")
    keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    mask = torch.zeros((seq, seq), dtype=torch.bfloat16, device="cuda")
    return mask.masked_fill_(~keep, float("-inf"))


def first_sdpa_backend(torch, candidates, sdpa):
    """The first of `candidates` (SDPBackend members) that runs `sdpa`
    on its own: the yardstick's backend where the dispatcher's choice
    would not say which."""
    from torch.nn.attention import sdpa_kernel
    for backend in candidates:
        try:
            with sdpa_kernel([backend]):
                sdpa()
            return backend
        except RuntimeError:
            continue
    raise AssertionError(f"none of {candidates} runs this shape")


def time_dense_attention(torch, fa, ref, ra, gen, card, shape, seq) -> dict:
    """10a, 11a, 12b, 13b: kernel 4 at one shape of
    `dense_attention_shapes`, `moe_attention_shapes` or
    `frontend_attention_shapes` over `seq` tokens (bf16, B 1, causal or
    not, the real window and softcap): its C entry back to back, the
    blockwise plain version once, and scaled_dot_product_attention on a
    fused backend as a yardstick the port never calls, on k and v
    repeated to Hq heads: causal (or, for an encoder, without a mask)
    and without a softcap; for a window, with the window as an additive
    mask, which makes it compute all L^2 pairs; for a head dim of v
    apart from q's (MLA), on the first fused backend that takes it,
    named."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    label, hq, hkv, d, dv, window, softcap, calls, causal = shape
    dt = torch.bfloat16
    q, k, v = attention_inputs(torch, gen, 1, hq, hkv, seq, seq, d, dt, dv)
    scale = 1.0 / math.sqrt(d)
    kw = dict(causal=causal, window=window, softcap=softcap, sm_scale=scale)
    out = fa.flash_attention(q, k, v, **kw)
    lib = fa._library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 1,
            hq, hkv, seq, seq, d, dv, seq, int(causal), window or 0,
            float(softcap or 0.0), scale,
            torch.cuda.current_stream().cuda_stream)
    kernel_ms = time_ms(lambda: lib.repro_flash_attention_fwd(*args),
                        iters=5, warmup=1)
    plain = blockwise_attention(torch, ref, ra, q, k, v, **kw)
    err, over = attention_over(torch, out, plain, dt)
    plain_ms = time_ms(lambda: blockwise_attention(
        torch, ref, ra, q, k, v, **kw), iters=1, warmup=0)
    del plain
    kr = k.repeat_interleave(hq // hkv, 1)
    vr = v.repeat_interleave(hq // hkv, 1)
    if window is None:
        backends = [SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION]
        yard = "causal" if causal else "no mask"
        sdpa_kw = dict(is_causal=causal)
    else:
        backends = [SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION]
        yard = f"the window as an additive mask, all {seq}^2 pairs"
        sdpa_kw = dict(attn_mask=window_mask(torch, seq, window))
    yard += ", no softcap" if softcap else ""

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, kr, vr, scale=scale, **sdpa_kw)

    if dv != d:
        backends = [first_sdpa_backend(torch, backends, sdpa)]
        yard += f", Dv {dv} against D {d} on {backends[0].name}"
    with sdpa_kernel(backends):
        sdpa_diff = (sdpa().float() - out.float()).abs().max().item()
        library_ms = time_ms(sdpa, iters=3, warmup=1)
    pairs, _ = mask_counts(seq, seq, causal, window)
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
        * q.element_size()
    ops_count = 2 * (d + dv) * pairs * hq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS_PER_S[str(dt)] * 1e3
    mask = "causal" if causal else "non-causal"
    log(f"  kernel 4 at {label} B1 Hq{hq} Hkv{hkv} L{seq} D{d} Dv{dv} bf16 "
        f"{mask} window {window} softcap {softcap} ({card}): {kernel_ms:.5f}"
        f" ms ({ops_count / kernel_ms / 1e9:.1f} TFLOP/s of kept products);"
        f" blockwise plain {plain_ms:.5f} ms (max|err| vs it {err:.3e}, "
        f"err/limit {over:.3f}); scaled_dot_product_attention ({yard}): "
        f"{library_ms:.5f} ms, max|diff| vs kernel 4 {sdpa_diff:.3e}, "
        f"kernel / sdpa {kernel_ms / library_ms:.3f}; bound "
        f"{max(t_bytes, t_ops):.6f} ms ({nbytes} B, "
        f"{ops_count} ops of the {pairs} kept pairs a head at the bf16 "
        f"rate)")
    if not over <= 1.0:
        raise AssertionError(f"kernel 4 at {label} L{seq}: err/limit {over}")
    del q, k, v, kr, vr, out, sdpa_kw
    torch.cuda.empty_cache()
    dims = f"D {d}" if dv == d else f"D {d}, Dv {dv}"
    return dict(shape=f"{label} (B 1, Hq {hq}, Hkv {hkv}, L {seq}, {dims}, "
                f"bf16, {mask}, window {window}, softcap {softcap})",
                calls=calls, max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def prefill_dense(torch, np, mod, ops, ref, ra, cfg=None):
    """10b, 10d, 11b, 11c, 12c, 13c: build_prefill on `mod`'s model at
    full width (`cfg`, default its CONFIG; seeded random weights in its
    param_dtype, bf16 compute) over SERVE_RUN's prompt (`prefill_inputs`:
    hubert's frames, phi-3-vision's tokens and frontend embeds): exactly
    one kernel-4 launch a layer, each with the reference's window for
    that layer and the config's causal flag, and finite logits; the wall
    of a second prefill too (the first call in a
    process carries one-time start-up: `tools/profile_prefill` read 8.8
    s for danube's, then 0.75); then the same prefill with kernel 4 held
    to `blockwise_attention` on every query row of each call, each
    checked as it happens, the plain output carried on.
    Returns (params, the launch counts of the path)."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    from repro_torch.tools.profile_prefill import prefill_inputs
    cfg, run = cfg or mod.CONFIG, mod.SERVE_RUN
    params = transformer.init_params(cfg, seed=0, device="cuda")
    n_params = sum(w.numel() for w in tree_flatten(params)[0])
    n_bytes = sum(w.numel() * w.element_size()
                  for w in tree_flatten(params)[0])
    batch = prefill_inputs(cfg, run, "cuda")
    prefill = sstep.build_prefill(cfg)
    kernel = ops._fa.flash_attention
    windows, causal = [], []

    def spy(q, k, v, **kw):
        windows.append(kw.get("window"))
        causal.append(kw.get("causal"))
        return kernel(q, k, v, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(ops._fa, "flash_attention", spy):
        _reset_counts()                              # path starts
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()                           # path ends
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    again = time.perf_counter() - t0
    want_windows = reference_windows(cfg)
    log(f"  prefill {cfg.name} ({n_params} parameters, {n_bytes / 2**30:.3f}"
        f" GiB of {cfg.param_dtype} weights; {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} q heads over {cfg.n_kv_heads} KV "
        f"heads of {cfg.hd}, vocab {cfg.vocab}), batch "
        f"{run['prefill_batch']} x L {run['prefill_len']} ("
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
        + f"): wall {wall:.3f} s first, {again:.3f} s again ("
        f"{run['prefill_batch'] * run['prefill_len'] / again:.1f} "
        f"{'frames' if cfg.frontend == 'audio' else 'prompt tok'}/s), peak "
        f"memory {peak / 2**30:.3f} GiB, launches {counts}, "
        f"windows {dict((w, windows.count(w)) for w in set(windows))}, "
        f"causal {dict((c, causal.count(c)) for c in set(causal))}")
    want = dict({name: 0 for name in counts}, flash_attention=cfg.n_layers)
    if counts != want or windows != want_windows \
            or causal != [cfg.causal] * cfg.n_layers:
        raise AssertionError(f"prefill launches {counts} with windows "
                             f"{windows}, causal {causal}, want {want} with "
                             f"{want_windows}, causal {cfg.causal}")
    if logits.shape != (run["prefill_batch"], 1, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    over = []

    def attn_both(q, k, v, **kw):
        got = kernel(q, k, v, **kw)
        want = blockwise_attention(torch, ref, ra, q, k, v, **kw)
        over.append(attention_over(torch, got, want, q.dtype)[1])
        return want

    t0 = time.perf_counter()
    with mock.patch.object(ops._fa, "flash_attention", attn_both):
        plain = prefill(params, batch)
    torch.cuda.synchronize()
    both_wall = time.perf_counter() - t0
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  in the bf16 prefill, on each call's inputs: kernel 4 vs the "
        f"blockwise plain version on every query row of all {len(over)} "
        f"calls, worst err/limit {max(over):.3f} (per call: "
        + " ".join(f"{x:.3f}" for x in over)
        + f"); plain + kernel prefill wall {both_wall:.3f} s; bf16 logits "
        f"kernel path vs that path (not gated, see MAMBA_F32_LOGITS_RTOL): "
        f"max|err| {err:.4e}, max|logit| {scale:.4f}; argmax "
        f"{int(logits.argmax())} vs {int(plain.argmax())}")
    if len(over) != cfg.n_layers or not max(over) <= 1.0:
        raise AssertionError(f"kernel 4 in the prefill's calls: err/limit "
                             f"{over}")
    del logits, plain, batch
    torch.cuda.empty_cache()
    return params, counts


def f32_gate(torch, mod, ops, ref, ra, params, length) -> None:
    """10b, 12c, 13c: `mod`'s model in f32 compute over the first `length`
    positions of SERVE_RUN's prompt (`prefill_inputs`; frontend embeds
    whole), `forward` through kernel 4 and through the blockwise plain
    version: the last position's logits (the prefill's) within
    DENSE_F32_LOGITS_RTOL of the largest.  An encoder's hidden state is
    held at every position too, each within that share of the
    position's largest |h|: a bidirectional layer mixes every position
    into every other, so a fault at any row shows anywhere.  With
    frontend embeds, the kernel path's logits without them must differ
    from those with them by more than the tolerance: the embeds reach
    the output."""
    from repro_torch.models import layers, transformer
    from repro_torch.parallel.comm import Comm
    from repro_torch.tools.profile_prefill import prefill_inputs
    cfg = dataclasses.replace(mod.CONFIG, dtype=torch.float32)
    batch = {k: v if k == "frontend_embeds" else v[:, :length]
             for k, v in prefill_inputs(mod.CONFIG, mod.SERVE_RUN,
                                        "cuda").items()}
    comm = Comm()

    @torch.no_grad()
    def run(attn, inputs):
        t0 = time.perf_counter()
        with mock.patch.object(ops._fa, "flash_attention", attn):
            h, _ = transformer.forward(
                comm, cfg, params, inputs.get("tokens"),
                frames=inputs.get("frames"),
                frontend_embeds=inputs.get("frontend_embeds"))
            logits = layers.lm_logits(comm, cfg, params["embed"], h[:, -1:])
        torch.cuda.synchronize()
        return h, logits, time.perf_counter() - t0

    def attn_plain(q, k, v, **kw):
        return blockwise_attention(torch, ref, ra, q, k, v, **kw)

    h, logits, wall32 = run(ops._fa.flash_attention, batch)
    h_plain, plain, _ = run(attn_plain, batch)
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    tol = DENSE_F32_LOGITS_RTOL
    over = [not torch.isfinite(logits).all(), err > tol * scale]
    msg = (f"  f32 {cfg.name} over {length} positions ("
           + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
           + f"), logits kernel path vs plain path: max|err| {err:.4e}, "
           f"max|logit| {scale:.4f}, rel {err / scale:.3e} (tol {tol}); "
           f"argmax {int(logits.argmax())} vs {int(plain.argmax())}; "
           f"kernel-path wall {wall32:.3f} s")
    if cfg.is_encoder:
        rel = ((h - h_plain).abs().amax(-1)
               / h_plain.abs().amax(-1)).max().item()
        msg += (f"; hidden state at all {h.shape[1]} positions, worst "
                f"max|err| / max|h| of a position {rel:.3e} (tol {tol})")
        over.append(not rel <= tol)
    if "frontend_embeds" in batch:
        _, bare, _ = run(ops._fa.flash_attention,
                         {k: v for k, v in batch.items()
                          if k != "frontend_embeds"})
        moved = (logits - bare).abs().max().item()
        msg += (f"; without the frontend embeds the logits move by "
                f"{moved:.4e} ({moved / scale:.3e} of the largest, must "
                f"exceed {tol})")
        over.append(not moved > tol * scale)
    log(msg)
    if any(over):
        raise AssertionError(f"f32 gate of {cfg.name}: failed checks "
                             f"{over} (non-finite, logits, then hidden "
                             f"state or embeds)")
    del h, h_plain, logits, plain, batch
    torch.cuda.empty_cache()


def long_decode_dense(torch, np, mod, params, cfg=None) -> None:
    """10c, 11c, 13e: one build_decode_step of `mod`'s model (`cfg`,
    default its CONFIG: gemma2, phi-3-vision; deepseek-v3 cut to 4
    layers) at SERVE_RUN's long
    decode, batch `long_batch` against caches of `long_cache_len` slots
    (gemma2's local layers: rings of local_window slots; MLA: the latent
    c_kv and k_rope), every cache leaf filled from a generator seeded by
    its index, at the last position: finite logits; each full-length
    cache changed only at that slot and each ring only at that slot
    modulo its length, in every row, checked against each leaf's
    contents regenerated from its seed, one leaf at a time (no copy of
    the caches); then the wall of a few more steps and the peak
    memory."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.models import transformer
    from repro_torch.serve import step as sstep
    cfg, run = cfg or mod.CONFIG, mod.SERVE_RUN
    B, S = run["long_batch"], run["long_cache_len"]
    cache = transformer.init_cache(cfg, 1, B, S, device="cuda")
    leaves = tree_flatten(cache)[0]

    def fill(j):
        gen = torch.Generator(device="cuda").manual_seed(1000 + j)
        return torch.randn(leaves[j].shape, generator=gen,
                           device="cuda").to(leaves[j].dtype)

    for j, leaf in enumerate(leaves):
        leaf.copy_(fill(j))
    gen = torch.Generator(device="cuda").manual_seed(1)
    decode = sstep.build_decode_step(cfg)
    batch = {"tokens": torch.randint(1, cfg.vocab, (B, 1), generator=gen,
                                     device="cuda"),
             "positions": torch.full((B,), S - 1, device="cuda")}
    nbytes = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
    slots = sorted({leaf.shape[1] for leaf in leaves})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    logits, cache = decode(params, cache, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    changed = set()
    for j, leaf in enumerate(tree_flatten(cache)[0]):
        moved = (leaf != fill(j)).flatten(2).any(-1)       # (B, slots)
        n = leaf.shape[1]
        changed.add((n, tuple(moved.nonzero()[:, 1].unique().tolist()),
                     int(moved[:, (S - 1) % n].sum())))
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        logits_n, cache = decode(params, cache, batch)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / steps
    log(f"  long decode {cfg.name}: batch {B}, {len(leaves)} cache leaves"
        f" of {slots} slots ({nbytes / 1e9:.3f} GB), position "
        f"{S - 1}: first step {first * 1e3:.3f} ms, then {per_step * 1e3:.3f}"
        f" ms a step over {steps}; peak memory {peak / 2**30:.3f} GiB; "
        f"launches {counts}; (slots, slots changed, rows changed there) "
        f"{sorted(changed)}")
    want = {(n, ((S - 1) % n,), B) for n in slots}
    if changed != want:
        raise AssertionError(f"the decode step changed {sorted(changed)}, "
                             f"want {sorted(want)}")
    if logits.shape != (B, 1, cfg.vocab) or not (
            torch.isfinite(logits).all() and torch.isfinite(logits_n).all()):
        raise AssertionError(f"long-decode logits {tuple(logits.shape)} are "
                             f"not finite")
    del cache, leaves, logits, logits_n
    torch.cuda.empty_cache()


def launch_dense(torch, np, mod, ref, layers, logits_check=False) -> dict:
    """10b, 10d, 13d: `python -m repro_torch.launch.serve --arch <arch>`
    through its main() at the reference's defaults (the paged engine, batch 4,
    prompt 32, 16 tokens, max_seq max(--cache-len 128, 48)): (4, 16)
    tokens and one paged prefill of kernel-4 launches per layer per
    request (counts set to 0 just before, read just after).  With
    `logits_check`, one request's prefill logits through the kernel
    against those through the plain version (phase 3's rule,
    PREFILL_LOGITS_RTOL of the largest) on the engine's weights.  Returns
    the launch counts."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import engine as serve_engine
    cfg, run = mod.CONFIG, mod.SERVE_RUN
    built = []

    class Recording(serve_engine.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(serve_engine, "ServeEngine", Recording):
        _reset_counts()                              # path starts
        t0 = time.perf_counter()
        gen = launch_serve.main(["--arch", cfg.name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()                           # path ends
    peak = torch.cuda.max_memory_allocated()
    (eng,) = built
    want = (run["batch"], run["new_tokens"])
    log(f"  launch.serve main ({cfg.name}, paged engine: batch "
        f"{run['batch']}, prompt {run['prompt_len']}, {run['new_tokens']} "
        f"tokens, max_seq {eng.max_seq}, {eng.kv.pool.num_pages} pages of "
        f"{eng.page_size}): tokens {gen.shape}, wall {wall:.3f} s with the "
        f"weights' init, {gen.size / wall:.1f} tok/s, peak memory "
        f"{peak / 2**30:.3f} GiB, {eng.steps} engine steps, launches "
        f"{counts}; first row {gen[0].tolist()}")
    want_counts = dict({name: 0 for name in counts},
                       flash_attention=cfg.n_layers * run["batch"])
    if gen.shape != want or counts != want_counts \
            or eng.max_seq != max(run["cache_len"],
                                  run["prompt_len"] + run["new_tokens"]):
        raise AssertionError(f"launcher gave {gen.shape}, launches {counts}"
                             f", max_seq {eng.max_seq}; want {want}, "
                             f"{want_counts}")
    if logits_check:
        prompts = np.random.default_rng(0).integers(
            1, cfg.vocab, size=(run["batch"], run["prompt_len"]),
            dtype=np.int32)

        def first_logits():
            e = serve_engine.ServeEngine(
                cfg, params=eng.params, device="cuda", capture_logits=True,
                max_slots=eng.max_slots, page_size=eng.page_size,
                max_seq=eng.max_seq, prompt_bucket=eng.prompt_bucket)
            r = e.submit(prompts[0], 1)
            e.run()
            return e.logits_trace[r][0]

        kernel = first_logits()
        with mock.patch.object(layers.kops, "attention", ref.attention_ref):
            plain = first_logits()
        err = float(np.abs(kernel - plain).max())
        scale = float(np.abs(plain).max())
        log(f"  prefill logits of request 0 through the engine, kernel vs "
            f"plain: max|err| {err:.4e}, max|logit| {scale:.4f}, tol "
            f"{PREFILL_LOGITS_RTOL * scale:.4e}; argmax "
            f"{int(kernel.argmax())} vs {int(plain.argmax())}")
        if kernel.shape != (cfg.vocab,) or not np.isfinite(kernel).all() \
                or not err <= PREFILL_LOGITS_RTOL * scale:
            raise AssertionError(f"prefill logits {kernel.shape} differ by "
                                 f"{err}")
    built.clear()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 11: the moe family at full width — kernel 4 at granite's and MLA's
# shapes; granite-moe-3b-a800m, deepseek-v3 over 4 of its 61 layers
# ---------------------------------------------------------------------------

# each model's prefill in f32 compute through kernel 4 and through the
# blockwise plain version over the first MOE_F32_LEN tokens of the prompt
# (gemma2's GEMMA_F32_LEN, for the same reason).  The router turns any
# change of summation order into a different expert where two gates are
# near-tied or a token sits at an expert's capacity, and a changed pick
# moves the drops of later tokens in that expert: so each layer's routes
# (top-k experts, kept flags) are recorded on both paths.  Where all
# agree, the logits are held within MOE_F32_RTOL of the largest; where
# some differ, the layer outputs before the first layer that differs are
# held within MOE_F32_RTOL of their largest and that layer's differing
# picks must be fewer than MOE_ROUTE_SHARE of its T x K
MOE_F32_LEN = 8192
MOE_F32_RTOL = DENSE_F32_LOGITS_RTOL
MOE_ROUTE_SHARE = 1e-3


def moe_attention_shapes(granite_cfg, deepseek_cfg) -> list:
    """`dense_attention_shapes`' tuples of the two kinds of kernel-4
    call of the moe prefills: granite's GQA layers, and deepseek-v3's
    MLA (q and k at nope + rope, v at v_dim, one KV head a q head)."""
    g, ds = granite_cfg, deepseek_cfg
    m = ds.mla
    return [(g.name, g.n_heads, g.n_kv_heads, g.hd, g.hd, None, None,
             g.n_layers, True),
            (ds.name + " MLA", ds.n_heads, ds.n_heads,
             m.qk_nope_dim + m.qk_rope_dim, m.v_dim, None, None,
             ds.n_layers, True)]


def moe_f32_gate(torch, np, cfg, run, ops, ref, ra, params) -> None:
    """11b, 11c: `cfg`'s prefill in f32 compute over the first
    MOE_F32_LEN tokens of SERVE_RUN's prompt through kernel 4 and through
    the blockwise plain version, each layer's routes and block outputs
    recorded, gated by the rule at MOE_F32_LEN."""
    from repro_torch.models import layers, transformer
    from repro_torch.serve import step as sstep
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, size=(run["prefill_batch"], run["prefill_len"])),
        device="cuda")[:, :MOE_F32_LEN]
    prefill32 = sstep.build_prefill(dataclasses.replace(
        cfg, dtype=torch.float32))
    real_route, real_block = layers.moe_route, transformer._attn_block
    kernel = ops._fa.flash_attention

    def run_path(attn):
        routes, outs = [], []

        def route(*a):
            r = real_route(*a)
            routes.append((r[2], r[4]))               # tope, keep
            return r

        def block(*a, **kw):
            x, aux = real_block(*a, **kw)
            outs.append(x)
            return x, aux

        t0 = time.perf_counter()
        with mock.patch.object(layers, "moe_route", route), \
                mock.patch.object(transformer, "_attn_block", block), \
                mock.patch.object(ops._fa, "flash_attention", attn):
            logits = prefill32(params, {"tokens": tokens})
        torch.cuda.synchronize()
        return logits, routes, outs, time.perf_counter() - t0

    def attn_plain(q, k, v, **kw):
        return blockwise_attention(torch, ref, ra, q, k, v, **kw)

    logits, routes, outs, wall = run_path(kernel)
    plain, p_routes, p_outs, plain_wall = run_path(attn_plain)
    nd = cfg.moe.first_dense_layers
    picks = tokens.numel() * cfg.moe.top_k
    differ = [int(((te != pe).reshape(-1) | (kp != pk)).sum())
              for (te, kp), (pe, pk) in zip(routes, p_routes)]
    out_rel = [(a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(outs, p_outs)]
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    log(f"  f32 prefill {cfg.name} over {tokens.shape[1]} tokens, kernel 4 "
        f"vs the blockwise plain version: {len(routes)} MoE layers of "
        f"{picks} (token, k) picks, picks that differ per layer {differ}; "
        f"block outputs max|err| / max|out| per block "
        + " ".join(f"{x:.2e}" for x in out_rel)
        + f"; logits max|err| {err:.4e}, max|logit| {scale:.4f}, rel "
        f"{err / scale:.3e} (tol {MOE_F32_RTOL}); argmax "
        f"{int(logits.argmax())} vs {int(plain.argmax())}; walls "
        f"{wall:.3f} s (kernel) and {plain_wall:.3f} s (plain)")
    if len(routes) != cfg.n_layers - nd or len(outs) != cfg.n_layers \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"f32 prefill: {len(routes)} routes, "
                             f"{len(outs)} blocks, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    if not any(differ):
        if not err <= MOE_F32_RTOL * scale:
            raise AssertionError(f"f32 prefill logits differ by {err} "
                                 f"(max|logit| {scale}) with every route "
                                 f"equal")
    else:
        first = next(i for i, n in enumerate(differ) if n)
        log(f"  routes differ first in MoE layer {first} (block "
            f"{nd + first}): {differ[first]} of {picks} picks "
            f"({differ[first] / picks:.2e}, limit {MOE_ROUTE_SHARE}); the "
            f"{nd + first} blocks before it within "
            f"{max(out_rel[:nd + first], default=0.0):.3e} (tol "
            f"{MOE_F32_RTOL})")
        if not (differ[first] < MOE_ROUTE_SHARE * picks
                and all(x <= MOE_F32_RTOL for x in out_rel[:nd + first])):
            raise AssertionError(f"f32 prefill: routes differ in layer "
                                 f"{first} at {differ[first]} of {picks} "
                                 f"picks; block outputs {out_rel}")
    del logits, plain, routes, p_routes, outs, p_outs, tokens
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 12-13: the audio and vlm families at full width — kernel 4 at
# hubert-xlarge's non-causal D 80 and phi-3-vision-4.2b's D 96
# ---------------------------------------------------------------------------

# hubert's f32 gate over this many frames (gemma2's GEMMA_F32_LEN, for
# the same reason); phi-3-vision's takes GEMMA_F32_LEN tokens
AUDIO_F32_LEN = GEMMA_F32_LEN


def frontend_attention_shapes(hubert_cfg, phi_cfg) -> list:
    """`dense_attention_shapes`' tuples of the two frontends' kernel-4
    calls: hubert's non-causal 16 heads of 80 (a KV head a q head) and
    phi-3-vision's causal 32 heads of 96."""
    return [(c.name, c.n_heads, c.n_kv_heads, c.hd, c.hd, c.window,
             c.softcap, c.n_layers, c.causal) for c in (hubert_cfg, phi_cfg)]


def encoder_launcher(torch, mod) -> None:
    """12d: `python -m repro_torch.launch.serve --arch <encoder>` through
    its main() raises the reference's SystemExit("encoder-only arch has no
    decode loop") before any work on the card: no launch, no memory."""
    from repro_torch.launch import serve as launch_serve
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _reset_counts()                                  # path starts
    try:
        launch_serve.main(["--arch", mod.CONFIG.name])
        said = None
    except SystemExit as e:
        said = str(e)
    torch.cuda.synchronize()
    counts = _counts()                               # path ends
    grew = torch.cuda.memory_allocated() - before
    log(f"  launch.serve main ({mod.CONFIG.name}): SystemExit {said!r}, "
        f"launches {counts}, memory allocated meanwhile {grew} B")
    if said != "encoder-only arch has no decode loop" or any(
            counts.values()) or grew:
        raise AssertionError(f"the encoder's launcher said {said!r}, "
                             f"launched {counts}, allocated {grew} B")


# ---------------------------------------------------------------------------
# phase 14: the measurement services on the card
# ---------------------------------------------------------------------------

# the train launcher's autotune grid (`repro/launch/train.py`), over both
# collectives Tuner.tune sweeps
TUNE_GRID = {"collectives": ("allreduce", "fcollect"),
             "sizes": (4096, 65536, 1 << 20), "chunks": (1, 4),
             "iters": 3, "warmup": 1}
# the same call's wall through the profiler and on the host clock ended by
# a device wait, at 1 GiB: within this fraction of each other
PROFILE_WALL_RTOL = 0.2
# the fields of a sample fixed by the call alone (not by its timing)
SAMPLE_TIMES = ("wall_s", "t_start", "issue_s", "stall_s")


def _service_calls(ctx, x, xa, full: bool):
    """Phase 5's collectives through the context's methods, each one op
    sample under a profiler: to_all rd and ring and reduce_scatter (the
    bucket's), then (`full`) broadcast, fcollect, collect, alltoall and
    barrier (the message-size sweep's)."""
    calls = [("to_all rd", lambda: ctx.to_all(x, "sum", algorithm="rd")),
             ("to_all ring", lambda: ctx.to_all(x, "sum", algorithm="ring")),
             ("reduce_scatter", lambda: ctx.reduce_scatter(x))]
    if full:
        calls += [("broadcast", lambda: ctx.broadcast(x, 5)),
                  ("fcollect", lambda: ctx.fcollect(x)),
                  ("collect", lambda: ctx.collect(x)),
                  ("alltoall", lambda: ctx.alltoall(xa)),
                  ("barrier", lambda: ctx.barrier())]
    return calls


def _sample_fields(prof) -> list:
    return [{k: v for k, v in smp.to_dict().items() if k not in SAMPLE_TIMES}
            for smp in prof.samples]


def services_profiler(torch, np, card) -> dict:
    """14a: a level-2 Profiler on sim_ctx(16) over the paper's 4x4 mesh on
    the card; phase 5's collectives at 8 B per PE (the sweep's set) and
    at 1 GiB PE-stacked (the bucket's set: to_all rd, ring,
    reduce_scatter).  Each call gives exactly one sample whose fields
    (algorithm, chunks, embedding, schedule, bytes moved, hottest-link
    load, predicted_s under the board's link model...) equal those of
    the same call on sim_ctx(16, device="cpu"); kernels 1-3 launch the
    same counts with no profiler, with pcontrol(0) and with pcontrol(2);
    at 1 GiB each sample's wall_s agrees with a host-clock wall of the
    same call ended by a device wait within PROFILE_WALL_RTOL.  Returns
    the launches of the profiled 8 B run (counts set to 0 just before,
    read just after)."""
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import Profiler, abmodel, sim_ctx
    n, topo, link = paper.N_PES, paper.TOPOLOGY, abmodel.EPIPHANY_NOC
    rng = np.random.default_rng(14)
    small = rng.standard_normal((n, 2), dtype=np.float32)       # 8 B / PE
    small_a = rng.standard_normal((n, n), dtype=np.float32)
    prof = Profiler(level=2)
    ctx = sim_ctx(n, topo, link=link, device="cuda", profile=prof)
    bare = sim_ctx(n, topo, link=link, device="cuda")
    cpu_prof = Profiler(level=2)
    cpu = sim_ctx(n, topo, link=link, device="cpu", profile=cpu_prof)

    def run(c, x, xa, full):
        for _, fn in _service_calls(c, x, xa, full):
            fn()

    xs = torch.from_numpy(small).to("cuda")
    xas = torch.from_numpy(small_a).to("cuda")
    counts = {}
    for label, c, level in (("no profiler", bare, None),
                            ("pcontrol(0)", ctx, 0),
                            ("pcontrol(2)", ctx, 2)):
        if level is not None:
            ctx.pcontrol(level)
        prof.reset()
        torch.cuda.synchronize()
        _reset_counts()                                 # path starts
        run(c, xs, xas, True)
        torch.cuda.synchronize()
        counts[label] = _counts()                       # path ends
    n_ops = len(_service_calls(ctx, xs, xas, True))
    if len(prof.samples) != n_ops or prof.counters() == {}:
        raise AssertionError(f"8 B: {len(prof.samples)} samples for "
                             f"{n_ops} collectives")
    if not (counts["no profiler"] == counts["pcontrol(0)"]
            == counts["pcontrol(2)"]):
        raise AssertionError(f"the profiler changed the launches: {counts}")
    run(cpu, torch.from_numpy(small), torch.from_numpy(small_a), True)
    got, want = _sample_fields(prof), _sample_fields(cpu_prof)
    if got != want:
        raise AssertionError(f"8 B samples on the card != the CPU SIM's:\n"
                             f"{got}\n{want}")
    log(f"  8 B per PE: {n_ops} collectives, one sample each, fields equal "
        f"to the CPU SIM's; launches with no profiler, pcontrol(0) and "
        f"pcontrol(2) all {counts['pcontrol(2)']}")

    # 1 GiB PE-stacked (64 MiB per PE), the bucket's collectives
    big = torch.zeros((n, BUCKET_ELEMS), device="cuda")
    big.uniform_(-1.0, 1.0, generator=torch.Generator(
        device="cuda").manual_seed(14))
    rows = []
    for name, fn in _service_calls(bare, big, None, False):
        fn()                                            # warm the allocator
        torch.cuda.synchronize()
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t)
        rows.append([name, min(host)])
    prof.reset()
    for _ in range(3):
        for _, fn in _service_calls(ctx, big, None, False):
            fn()
    walls = [smp.wall_s for smp in prof.samples]
    k = len(rows)
    if len(walls) != 3 * k:
        raise AssertionError(f"1 GiB: {len(walls)} samples for {3 * k} "
                             f"calls")
    for i, row in enumerate(rows):
        row.append(min(walls[i::k]))
    big_fields = _sample_fields(prof)[:k]
    del big
    torch.cuda.empty_cache()
    cpu_prof.reset()
    big_cpu = torch.zeros((n, BUCKET_ELEMS))
    run(cpu, big_cpu, None, False)
    del big_cpu
    if big_fields != _sample_fields(cpu_prof):
        raise AssertionError(f"1 GiB samples on the card != the CPU SIM's:"
                             f"\n{big_fields}\n{_sample_fields(cpu_prof)}")
    log(f"  1 GiB PE-stacked ({card}; min of 3 each): "
        + "; ".join(f"{name} sample wall_s {p * 1e3:.3f} ms, host clock "
                    f"{h * 1e3:.3f} ms (x{p / h:.3f})"
                    for name, h, p in rows)
        + "; sample fields equal to the CPU SIM's")
    for name, h, p in rows:
        if abs(p / h - 1.0) > PROFILE_WALL_RTOL:
            raise AssertionError(f"{name} at 1 GiB: the profiler's wall "
                                 f"{p} s vs the host clock's {h} s")
    return counts["pcontrol(2)"]


def services_tuner(torch, np, card) -> dict:
    """14b: Tuner.tune on the profiled 16-PE context on the card over
    TUNE_GRID: `points` and `variants` as `_variants` gives them, kernel
    launches (warmup + iters) x each variant's per-call count, summed,
    plus refit_link's (its measure calls at their defaults: 2 warmup + 5
    timed, one put_copy per ppermute), each best the argmin of its
    recorded means, the tuned allreduce within the CPU test's tolerance
    of the untuned one, and the fitted link constants printed as the
    card's.  Returns the launches of the sweep."""
    from repro_torch.configs import epiphany16 as paper
    from repro_torch.core import Profiler, sim_ctx
    from repro_torch.core import collectives as coll
    from repro_torch.core import tuner as tuner_mod
    n, topo = paper.N_PES, paper.TOPOLOGY
    ctx = sim_ctx(n, topo, device="cuda", profile=Profiler(level=2))
    tuner = tuner_mod.Tuner()
    g = TUNE_GRID
    link = tuner.link_model(topo, n)
    per_call = {"put_copy": 0, "dma_copy": 0, "reduce_combine": 0}
    n_var = 0
    for collective in g["collectives"]:
        for nbytes in g["sizes"]:
            x = torch.zeros((n, nbytes // 4), device="cuda")
            for algo, c, emb in tuner._variants(collective, n, nbytes, topo,
                                                link, g["chunks"]):
                fn = coll.allreduce if collective == "allreduce" \
                    else coll.fcollect
                _reset_counts()
                fn(ctx.net, x, algorithm=algo, pipeline_chunks=c,
                   topo=topo, link=link, embedding=emb)
                one = _counts()
                for name in per_call:
                    per_call[name] += (g["warmup"] + g["iters"]) * one[name]
                n_var += 1
    sizes = sorted({max(4, int(sz)) for sz in g["sizes"]})
    pats = 3 if topo.snake_order() != tuple(range(n)) else 2
    per_call["put_copy"] += (len(sizes) + pats) * (2 + 5)
    torch.cuda.synchronize()
    _reset_counts()                                     # sweep starts
    t0 = time.perf_counter()
    summary = tuner.tune(ctx, g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _counts()                                     # sweep ends
    n_points = len(g["collectives"]) * len(g["sizes"])
    if (summary["points"], summary["variants"]) != (n_points, n_var):
        raise AssertionError(f"sweep {summary['points']} points, "
                             f"{summary['variants']} variants; want "
                             f"{n_points}, {n_var}")
    launched = {name: got[name] for name in per_call}
    if launched != per_call:
        raise AssertionError(f"sweep launches {launched}, the variants "
                             f"imply {per_call}")
    fp = summary["fingerprint"]
    for collective in g["collectives"]:
        for nbytes in g["sizes"]:
            var = tuner.db.variants(fp, collective, f"n{n}", nbytes)
            best = min(var, key=lambda v: var[v]["mean_s"])
            key = f"{collective}@{tuner_mod.nbytes_bucket(nbytes)}B"
            if summary["best"][key] != best:
                raise AssertionError(f"{key}: best {summary['best'][key]}, "
                                     f"argmin of the means {best}")
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((n, 65536 // 4), generator=gen, device="cuda")
    tuned = sim_ctx(n, topo, device="cuda", tuner=tuner)
    plain = sim_ctx(n, topo, device="cuda")
    a = tuned.to_all(x, "sum", algorithm="auto", pipeline_chunks="auto")
    b = plain.to_all(x, "sum", algorithm="auto")
    if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
        raise AssertionError("the tuned allreduce differs from the untuned "
                             "one beyond rtol 1e-4, atol 1e-4")
    lk = tuner.link_model(topo, n)
    picks = {f"{c}@{nb}": tuner.selector().schedule(c, n, nb, topo)
             for c in g["collectives"] for nb in g["sizes"]}
    log(f"  tune {fp}: {summary['points']} points, {summary['variants']} "
        f"variants in {wall:.2f} s, launches {launched} (= the variants' "
        f"(warmup + iters) x per-call + refit_link's); best {summary['best']}"
        f"; tuned picks {picks}; tuned to_all(auto, auto) == untuned within "
        f"rtol/atol 1e-4")
    log(f"  fitted link of the 16-PE SIM on {card}: alpha_s "
        f"{lk.alpha_s:.6e} s, bw_Bps {lk.bw_Bps:.6e} B/s, contention "
        f"{lk.contention:.4f}, hop_s {lk.hop_s:.3e} s (the prior's: the "
        f"cost model's default ICI_V5E)")
    return got


def services_attention(ring_walls) -> None:
    """14c: choose_attention at phase 8's ring shape: without a tuner the
    cost model's pick (the argmin of its modeled times, the reference's
    rule); with phase 8's measured ring and mono walls recorded under
    collective "attention", the variant with the smaller measured
    wall."""
    from repro_torch.core import fusion
    from repro_torch.core import tuner as tuner_mod
    n, kv, block = ring_walls["n"], ring_walls["kv_bytes"], \
        ring_walls["block_s"]
    pick, times = fusion.choose_attention(n, kv, block)
    model = "ring" if times["ring"] <= times["mono"] else "mono"
    db = tuner_mod.TuningDB()
    fp = tuner_mod.fingerprint(None, n)
    for algo in ("ring", "mono"):
        db.record(fp, "attention", f"n{n}", kv * n, algo, 1, None,
                  ring_walls[f"{algo}_s"])
    tuned, _ = fusion.choose_attention(n, kv, block,
                                       tuner=tuner_mod.TunedSelector(db))
    faster = min(("ring", "mono"), key=lambda a: ring_walls[f"{a}_s"])
    log(f"  choose_attention(n={n}, kv_block_bytes={kv}): untuned pick "
        f"{pick} (modeled ring {times['ring'] * 1e3:.6f} ms, mono "
        f"{times['mono'] * 1e3:.6f} ms); measured ring "
        f"{ring_walls['ring_s'] * 1e3:.3f} ms, mono "
        f"{ring_walls['mono_s'] * 1e3:.3f} ms; tuned pick {tuned}")
    if pick != model or tuned != faster:
        raise AssertionError(f"choose_attention: untuned {pick} (model "
                             f"{model}), tuned {tuned} (faster {faster})")


def services_engine(torch, np, serving, ServeEngine, served) -> dict:
    """14d: qwen2-0.5b's engine on phase 3's traffic with a LEVEL_FULL
    Tracer and ServeMetrics: tokens identical to phase 3's, both
    documents valid, exact request/token/page counts, and the registry's
    TTFT and per-token p50 beside phase 3's measures of this run, of an
    untraced run right after and of phase 3's run.  Returns the traced
    run's launches (counts set to 0 just before, read just after)."""
    from repro_torch.core.trace import LEVEL_FULL, Tracer
    from repro_torch.serve.metrics import ServeMetrics
    from repro_torch.tools.tracereport import (validate_metrics,
                                               validate_trace)
    cfg, engine_kw = serving.CONFIG, serving.SERVE_ENGINE
    n_req, prompt_len, new_tokens = (
        serving.SERVE_TRAFFIC[k] for k in ("requests", "prompt_len",
                                           "new_tokens"))
    tracer, metrics = Tracer(level=LEVEL_FULL), ServeMetrics()
    metrics.attach(tracer)
    eng = ServeEngine(cfg, device="cuda", init_seed=0, profile=tracer,
                      metrics=metrics, **engine_kw)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(n_req, prompt_len), dtype=np.int32)
    _reset_counts()                                     # path starts
    rids, ttft, gaps, _ = drive_engine(torch, eng, prompts, new_tokens)
    got = _counts()                                     # path ends
    for rid, want in zip(rids, served["tokens"]):
        if not np.array_equal(eng.results[rid], want):
            raise AssertionError(f"traced request {rid}: "
                                 f"{eng.results[rid].tolist()} != phase "
                                 f"3's {want.tolist()}")
    errs = validate_trace(tracer.to_chrome()) \
        + validate_metrics(metrics.to_json())
    m = metrics.registry
    counts = {k: m[f"serve.{k}"].value for k in (
        "requests_submitted", "requests_completed", "tokens_generated",
        "kv_pages_live")}
    want = {"requests_submitted": n_req, "requests_completed": n_req,
            "tokens_generated": n_req * new_tokens, "kv_pages_live": 0}
    if errs or counts != want:
        raise AssertionError(f"traced engine: schema errors {errs}, counts "
                             f"{counts} (want {want})")
    if got["flash_attention"] != cfg.n_layers * n_req:
        raise AssertionError(f"traced engine: {got} launches")
    n_events = len(tracer._events)
    # the same traffic untraced, right after: the host-bound engine's
    # per-token time moves by more between runs than the tracer costs
    bare = ServeEngine(cfg, params=eng.params, device="cuda", **engine_kw)
    _, ttft0, gaps0, _ = drive_engine(torch, bare, prompts, new_tokens)
    del bare
    log(f"  traced engine: tokens == phase 3's for all {n_req} requests; "
        f"{n_events} trace events and the metrics document valid; {counts}"
        f"; the registry's TTFT p50 {metrics.ttft_s.percentile(50) * 1e3:.2f}"
        f" ms (submit to first token) and per-token p50 "
        f"{metrics.per_token_s.percentile(50) * 1e3:.3f} ms (a decode "
        f"step's wall); phase 3's measures on this run: TTFT p50 "
        f"{pct(ttft, 50) * 1e3:.2f} ms, per-token p50 "
        f"{pct(gaps, 50) * 1e3:.3f} ms; untraced right after "
        f"{pct(ttft0, 50) * 1e3:.2f} and {pct(gaps0, 50) * 1e3:.3f} ms "
        f"(phase 3's untraced run {served['ttft_p50'] * 1e3:.2f} and "
        f"{served['per_token_p50'] * 1e3:.3f} ms); launches {got}")
    return got


def services_launcher(torch) -> dict:
    """14e: `launch.serve --arch qwen2-0.5b --trace-out --metrics-out` on
    the card writes documents that validate.  Returns its launches."""
    from repro_torch.launch import serve as serve_launch
    from repro_torch.tools.tracereport import (validate_metrics,
                                               validate_trace)
    out = ROOT / "build" / "phase14"
    out.mkdir(parents=True, exist_ok=True)
    tpath, mpath = out / "trace.json", out / "metrics.json"
    torch.cuda.synchronize()
    _reset_counts()                                     # path starts
    gen = serve_launch.main(["--arch", "qwen2-0.5b", "--trace-out",
                             str(tpath), "--metrics-out", str(mpath)])
    torch.cuda.synchronize()
    got = _counts()                                     # path ends
    tdoc, mdoc = json.loads(tpath.read_text()), json.loads(mpath.read_text())
    errs = validate_trace(tdoc) + validate_metrics(mdoc)
    done = mdoc["metrics"]["serve.requests_completed"]["value"]
    if errs or done != gen.shape[0] or got["flash_attention"] < 1:
        raise AssertionError(f"launcher documents: {errs}, completed "
                             f"{done} of {gen.shape[0]}, launches {got}")
    log(f"  launch.serve --trace-out --metrics-out: {gen.shape} tokens, "
        f"{len(tdoc['traceEvents'])} trace events, both documents valid; "
        f"launches {got}")
    return got


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

    from repro_torch.configs import deepseek_v3_671b as deepseek
    from repro_torch.configs import gemma2_9b as gemma
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.configs import h2o_danube_3_4b as danube
    from repro_torch.configs import hubert_xlarge as hubert
    from repro_torch.configs import internlm2_20b as internlm
    from repro_torch.configs import mamba2_2_7b as mamba
    from repro_torch.configs import phi_3_vision_4_2b as phi3v
    from repro_torch.configs import qwen2_0_5b as serving
    from repro_torch.configs import zamba2_1_2b as zamba
    from repro_torch.kernels import _build, ref, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.kernels import ssd_scan as kssd
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
    report_builds(libs)

    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_attention(torch, ops, ref, fa, gen)
    check_attention_edges(torch, fa, ref, gen)
    torch.cuda.empty_cache()
    timing = time_attention(torch, fa, ref, gen, card)

    log(f"== phase 3: serve {serving.CONFIG.name} at full width")
    eng, prompts, launches, served = serve(torch, np, fa, serving,
                                           ServeEngine)
    prefill_logits_check(torch, np, ref, layers, eng, prompts, serving,
                         ServeEngine)
    del eng, prompts

    log("== phase 4: runtime kernels against their plain versions")
    check_runtime_kernels(torch, gen)
    rt_timing = time_runtime_kernels(torch, gen)

    log("== phase 5: the OpenSHMEM runtime on 16 PEs")
    rt_launches = runtime(torch, np)

    log(f"== phase 6: train {serving.CONFIG.name} at full width")
    check_fused_update(torch)
    bucket_launches = fused_bucket(torch, np)
    trained = train(torch, np, serving)
    same_grads_both_optimizers(torch, serving, trained)
    trained_counts, n_params = trained["counts"], trained["n_params"]
    del trained
    torch.cuda.empty_cache()
    grads_through_the_kernel(torch, np, serving, ref, layers)
    fu_timing = time_fused_update(torch, n_params)

    log(f"== phase 7: serve {mamba.CONFIG.name} at full width")
    check_ssd(torch, ops, ref, gen)
    ssd_timing = time_ssd(torch, kssd, ref, gen)
    mamba_launches = serve_mamba(torch, np, mamba, ops, ref)
    decode_loop(torch, np, mamba)

    log(f"== phase 8: ring attention over {serving.RING_RUN['n_pes']} PEs "
        f"at {serving.CONFIG.name}'s width")
    check_ring_partials(torch, ra, ref, gen)
    ring_timing = time_ring_partials(torch, ra, ref, gen, card)
    ring_launches, ring_walls = ring_path(torch, np, serving, ra, ref, ops,
                                          fa, card)

    log(f"== phase 9: serve {zamba.CONFIG.name} at full width")
    check_zamba_kernels(torch, ops, ref, fa, ra, gen)
    time_ssd(torch, kssd, ref, gen, ZAMBA_SSD_SHAPE)
    time_zamba_attention(torch, fa, ref, ra, gen, card,
                         zamba.SERVE_RUN["prefill_len"])
    zamba_launches = serve_zamba(torch, np, zamba, ops, ref, ra)
    decode_loop(torch, np, zamba)
    decode_f32_vs_prefill(torch, np, zamba)
    long_decode(torch, np, zamba)

    log(f"== phase 10: serve {gemma.CONFIG.name}, {danube.CONFIG.name} and "
        f"{internlm.CONFIG.name} at full width")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  memory allocated as phase 10 starts: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    shapes = dense_attention_shapes((gemma, danube, internlm))
    check_dense_kernels(torch, ops, ref, fa, ra, gen, shapes)
    dense_timing = [time_dense_attention(torch, fa, ref, ra, gen, card, s,
                                         gemma.SERVE_RUN["prefill_len"])
                    for s in shapes]
    params, gemma_launches = prefill_dense(torch, np, gemma, ops, ref, ra)
    f32_gate(torch, gemma, ops, ref, ra, params, GEMMA_F32_LEN)
    long_decode_dense(torch, np, gemma, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dense_paths = [gemma_launches, launch_dense(torch, np, gemma, ref, layers,
                                                logits_check=True)]
    params, danube_launches = prefill_dense(torch, np, danube, ops, ref, ra)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dense_paths += [danube_launches, launch_dense(torch, np, danube, ref,
                                                  layers)]
    params, internlm_launches = prefill_dense(torch, np, internlm, ops, ref,
                                              ra)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dense_paths += [internlm_launches, launch_dense(torch, np, internlm, ref,
                                                    layers)]

    ds_cfg = dataclasses.replace(deepseek.CONFIG,
                                 n_layers=deepseek.SERVE_RUN["n_layers"])
    log(f"== phase 11: serve {granite.CONFIG.name} and {ds_cfg.name} "
        f"(cut to {ds_cfg.n_layers} of its {deepseek.CONFIG.n_layers} "
        f"layers) at full width")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  memory allocated as phase 11 starts: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    shapes = moe_attention_shapes(granite.CONFIG, ds_cfg)
    check_dense_kernels(torch, ops, ref, fa, ra, gen, shapes)
    moe_timing = [time_dense_attention(torch, fa, ref, ra, gen, card, s,
                                       granite.SERVE_RUN["prefill_len"])
                  for s in shapes]
    params, granite_launches = prefill_dense(torch, np, granite, ops, ref,
                                             ra)
    moe_f32_gate(torch, np, granite.CONFIG, granite.SERVE_RUN, ops, ref, ra,
                 params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    decode_loop(torch, np, granite)
    params, ds_launches = prefill_dense(torch, np, deepseek, ops, ref, ra,
                                        ds_cfg)
    moe_f32_gate(torch, np, ds_cfg, deepseek.SERVE_RUN, ops, ref, ra, params)
    long_decode_dense(torch, np, deepseek, params, ds_cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    decode_loop(torch, np, deepseek, ds_cfg)
    moe_paths = [granite_launches, ds_launches]

    log(f"== phase 12: serve {hubert.CONFIG.name} (an encoder) at full "
        f"width")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  memory allocated as phase 12 starts: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    hubert_shape, phi_shape = frontend_attention_shapes(hubert.CONFIG,
                                                        phi3v.CONFIG)
    check_dense_kernels(torch, ops, ref, fa, ra, gen, [hubert_shape])
    frontend_timing = [time_dense_attention(
        torch, fa, ref, ra, gen, card, hubert_shape,
        hubert.SERVE_RUN["prefill_len"])]
    params, hubert_launches = prefill_dense(torch, np, hubert, ops, ref, ra)
    f32_gate(torch, hubert, ops, ref, ra, params, AUDIO_F32_LEN)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    encoder_launcher(torch, hubert)

    log(f"== phase 13: serve {phi3v.CONFIG.name} with its frontend embeds "
        f"at full width")
    check_dense_kernels(torch, ops, ref, fa, ra, gen, [phi_shape])
    frontend_timing.append(time_dense_attention(
        torch, fa, ref, ra, gen, card, phi_shape,
        phi3v.SERVE_RUN["prefill_len"]))
    params, phi_launches = prefill_dense(torch, np, phi3v, ops, ref, ra)
    f32_gate(torch, phi3v, ops, ref, ra, params, GEMMA_F32_LEN)
    long_decode_dense(torch, np, phi3v, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    frontend_paths = [hubert_launches, phi_launches,
                      launch_dense(torch, np, phi3v, ref, layers,
                                   logits_check=True)]

    log("== phase 14: the measurement services on the card (profiler, "
        "tuner, choose_attention, traced engine, launcher)")
    gc.collect()
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    service_paths = [services_profiler(torch, np, card),
                     services_tuner(torch, np, card)]
    services_attention(ring_walls)
    service_paths += [services_engine(torch, np, serving, ServeEngine,
                                      served),
                      services_launcher(torch)]
    log(f"  phase 14 wall {time.perf_counter() - t14:.1f} s ({card})")

    # each path's counts, set to 0 just before it and read just after
    paths = [launches, rt_launches, bucket_launches] + trained_counts \
        + [mamba_launches] + ring_launches + [zamba_launches] + dense_paths \
        + moe_paths + frontend_paths + service_paths
    total = {name: sum(c.get(name, 0) for c in paths)
             for name in ("flash_attention", "put_copy", "dma_copy",
                          "reduce_combine", "fused_update", "ssd_scan",
                          "ring_attention")}
    log(f"  launches on the main paths: serve {launches}, runtime "
        f"{rt_launches}, fused bucket {bucket_launches}, train "
        f"{trained_counts}, mamba2 prefill {mamba_launches}, ring "
        f"attention (plain SIM, NoC SIM, mono, window+softcap) "
        f"{ring_launches}, zamba2 prefill {zamba_launches}, dense family "
        f"(gemma2 prefill, launcher; danube; internlm2) {dense_paths}, moe "
        f"family (granite prefill, deepseek prefill) {moe_paths}, audio "
        f"and vlm (hubert prefill, phi-3-vision prefill, launcher) "
        f"{frontend_paths}, services (profiled 8 B collectives, tune sweep, "
        f"traced engine, launcher) {service_paths}")
    rows = [("flash_attention", "src/repro_torch/kernels/csrc/"
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:79",
             timing)]
    rows += [(name, source, replaces, rt_timing[name])
             for name, source, replaces in RUNTIME_KERNELS]
    rows.append(("fused_update", "src/repro_torch/kernels/csrc/"
                 "fused_update.cu", "src/repro/kernels/fused_update.py:73",
                 dict(fu_timing["full"], max_abs_err=max(
                     fu_timing["full"]["max_abs_err"],
                     fu_timing["bucket16"]["max_abs_err"]))))
    rows.append(("ring_attention", "src/repro_torch/kernels/csrc/"
                 "ring_attention.cu", "src/repro/kernels/ring_attention.py:84",
                 ring_timing))
    rows.append(("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:86", ssd_timing))
    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=total[name],
                    max_abs_err=t["max_abs_err"], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=t["library_ms"])
               for name, source, replaces, t in rows]
    # kernel 4 at the dense, moe, audio and vlm families' prefill shapes,
    # each with the launches of that shape in its model's prefill
    kernels += [dict(name="flash_attention", route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:79",
                     shape=t["shape"], launches=t["calls"],
                     max_abs_err=t["max_abs_err"], ms=t["ms"],
                     plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                     bound_by=t["bound_by"], library_ms=t["library_ms"])
                for t in dense_timing + moe_timing + frontend_timing]
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

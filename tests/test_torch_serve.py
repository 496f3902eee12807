"""The port's serving slice on the CPU: the engine against the JAX engine
on the same weights, the port's own engine invariants (mirroring
tests/test_serve_engine.py), page bookkeeping driven through both
packages in lockstep, and the launcher."""
import collections
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.core.heap import HeapError as JHeapError
from repro.core.heap import SymmetricHeap as JHeap
from repro.launch.mesh import make_mesh
from repro.serve import PagedKV as JPagedKV
from repro.serve import PagePool as JPagePool
from repro.serve import PagePoolError as JPagePoolError
from repro.serve.engine import Scheduler as JScheduler
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.core.heap import HeapError, SymmetricHeap
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import PagedKV, PagePool, PagePoolError, pages_for
from repro_torch.serve.engine import Scheduler, ServeEngine

ARCH = "qwen2-0.5b"
KW = dict(max_slots=3, page_size=8, max_seq=32, prompt_bucket=16)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 prefill logits across the two frameworks: both round every matmul
# output to bf16 in their own order; allow 8 bf16 ulps (2^-8 relative
# spacing each) of the largest logit
BF16_RTOL_OF_MAX = 8 * 2.0 ** -8


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)          # tests/test_serve_engine.py's
    return [rng.integers(1, 1000, size=n).astype(np.int32)
            for n in (5, 9, 3, 12)]


def _port_engine(params=None, dtype=torch.float32, **kw):
    kw = {**KW, **kw}
    return ServeEngine(smoke_config(ARCH, dtype=dtype), params=params,
                       device="cpu", capture_logits=True, **kw)


@pytest.fixture(scope="module")
def jax_run(prompts):
    """The JAX engine (f32) serving the reference prompts, and its
    weights as numpy arrays."""
    eng = JServeEngine(smoke_config_f32(), make_mesh(1, 1),
                       capture_logits=True, **KW)
    rids = [eng.submit(p, 6) for p in prompts]
    eng.run()
    tree = jax.tree.map(np.asarray, eng.params)
    return tree, [eng.results[r] for r in rids], \
        [eng.logits_trace[r] for r in rids]


def smoke_config_f32():
    return jax_smoke(ARCH, dtype=jnp.float32)


def test_engine_matches_jax_engine_f32(prompts, jax_run):
    tree, jtokens, jlogits = jax_run
    cfg = smoke_config(ARCH, dtype=torch.float32)
    eng = _port_engine(params_from_jax(tree, cfg))
    rids = [eng.submit(p, 6) for p in prompts]
    eng.run()
    for rid, want_tok, want_lg in zip(rids, jtokens, jlogits):
        np.testing.assert_array_equal(eng.results[rid], want_tok)
        assert len(eng.logits_trace[rid]) == len(want_lg) == 6
        for got, want in zip(eng.logits_trace[rid], want_lg):
            np.testing.assert_allclose(got, want, **F32_TOL)


def test_engine_prefill_logits_match_jax_bf16():
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 128, size=n).astype(np.int32)
               for n in (5, 12)]
    jeng = JServeEngine(jax_smoke(ARCH), make_mesh(1, 1),
                        capture_logits=True, **KW)
    cfg = smoke_config(ARCH)                           # bf16 compute
    eng = _port_engine(params_from_jax(
        jax.tree.map(np.asarray, jeng.params), cfg), dtype=torch.bfloat16)
    for p in prompts:
        a, b = jeng.submit(p, 1), eng.submit(p, 1)
        jeng.run()
        eng.run()
        want, got = jeng.logits_trace[a][0], eng.logits_trace[b][0]
        tol = BF16_RTOL_OF_MAX * np.abs(want).max()
        assert np.abs(got - want).max() <= tol
        np.testing.assert_array_equal(eng.results[b], jeng.results[a])


# ---------------------------------------------------------------------------
# the port's own engine invariants (tests/test_serve_engine.py:143-195)
# ---------------------------------------------------------------------------

def test_port_batched_equals_alone_bitwise(prompts):
    eng = _port_engine()
    rids = [eng.submit(p, 6) for p in prompts]
    eng.run()
    assert eng.scheduler.idle()
    solo = _port_engine(params=eng.params)
    for rid, p in zip(rids, prompts):
        srid = solo.submit(p, 6)
        solo.run()
        np.testing.assert_array_equal(eng.results[rid], solo.results[srid])
        for a, b in zip(eng.logits_trace[rid], solo.logits_trace[srid]):
            np.testing.assert_array_equal(a, b)


def test_port_mid_batch_join_is_bitwise_transparent(prompts):
    eng = _port_engine()
    r0 = eng.submit(prompts[0], 8)
    eng.step(); eng.step(); eng.step()        # r0 is 3 tokens in
    r1 = eng.submit(prompts[1], 6)            # joins mid-batch
    eng.run()
    ref = _port_engine(params=eng.params)
    q1 = ref.submit(prompts[1], 6)
    ref.run()
    np.testing.assert_array_equal(eng.results[r1], ref.results[q1])
    q0 = ref.submit(prompts[0], 8)
    ref.run()
    np.testing.assert_array_equal(eng.results[r0], ref.results[q0])


def test_port_heap_backpressure_still_serves_everyone(prompts):
    probe = _port_engine()
    tight = probe.page_bytes * (4 + 1)        # 4 live pages + null
    eng = _port_engine(params=probe.params, kv_heap_bytes=tight)
    assert eng.pool["k"].shape[1] == eng.kv.pool.num_pages == 5
    rids = [eng.submit(p, 6) for p in prompts[:3]]
    eng.run()
    assert sorted(eng.results) == sorted(rids)
    assert all(len(eng.results[r]) == 6 for r in rids)
    assert eng.scheduler.n_admitted == 3
    assert eng.kv.pool.live_pages() == 0
    ref = _port_engine(params=probe.params)
    for rid, p in zip(rids, prompts[:3]):
        q = ref.submit(p, 6)
        ref.run()
        np.testing.assert_array_equal(eng.results[rid], ref.results[q])


def test_port_eos_stops_at_the_first_eos(prompts):
    eng = _port_engine()
    r = eng.submit(prompts[1], 8)
    eng.run()
    toks = eng.results[r].tolist()
    eos = toks[2]
    eng2 = _port_engine(params=eng.params, eos_id=eos)
    r2 = eng2.submit(prompts[1], 8)
    eng2.run()
    stop = toks.index(eos) + 1
    np.testing.assert_array_equal(eng2.results[r2], toks[:stop])


def test_engine_page_bytes_match_jax():
    jeng = JServeEngine(smoke_config_f32(), make_mesh(1, 1),
                        params=None, **KW)
    eng = _port_engine()
    assert eng.page_bytes == jeng.page_bytes
    assert eng.kv.pool.num_pages == jeng.kv.pool.num_pages


def test_engine_without_cuda_raises_unless_cpu_is_asked():
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(smoke_config(ARCH), **KW)


# ---------------------------------------------------------------------------
# host bookkeeping, driven through both packages in lockstep
# ---------------------------------------------------------------------------

def _drive_pools(heap_cls, pool_cls, kv_cls, err_cls):
    """One alloc/free/admit/evict sequence; returns everything observable."""
    log = []
    pool = pool_cls(heap_cls(9 * 256), 200)     # page_bytes aligns to 200
    kv = kv_cls(pool, 3, 4)
    for slot, rid, n in [(0, 0, 2), (1, 1, 3), (2, 2, 1)]:
        log.append(("admit", kv.admit(slot, rid, n, n * 8).pages))
    log.append(("brk", pool.heap.brk, pool.pages_available()))
    kv.evict(1)
    log.append(("table", kv.table.tolist(), pool.fragmentation()))
    log.append(("admit", kv.admit(1, 3, 4, 30).pages))
    try:
        kv.admit(1, 4, 1, 8)
    except err_cls as e:
        log.append(("error", type(e).__name__))
    try:
        pool.alloc(6)
    except err_cls as e:
        log.append(("error", type(e).__name__))
    for slot in (0, 2, 1):
        kv.evict(slot)
        log.append(("evict", slot, pool.live_pages(), pool.heap.brk,
                    round(pool.occupancy(), 6)))
    log.append(("table", kv.table.tolist(), pool.pages_available()))
    return log


def test_page_pools_match_jax_bitwise():
    assert _drive_pools(SymmetricHeap, PagePool, PagedKV, PagePoolError) \
        == _drive_pools(JHeap, JPagePool, JPagedKV, JPagePoolError)
    assert [pages_for(n, 8) for n in (0, 1, 8, 9, 17)] == [0, 1, 1, 2, 3]


def _drive_heap(heap_cls, err_cls):
    log = []
    h = heap_cls(1024)
    a = h.malloc(10)
    b = h.align_alloc(64, 100)
    c = h.malloc(7)
    log += [(x.offset, x.size, x.seq) for x in (a, b, c)] + [h.brk]
    c2 = h.realloc(c, 50)
    log += [(c2.offset, c2.size, c2.seq), h.brk]
    for bad in (lambda: h.realloc(b, 5), lambda: h.malloc(4096),
                lambda: h.malloc(8, align=12)):
        try:
            bad()
        except err_cls as e:
            log.append(type(e).__name__)
    h.free(b)
    log += [h.brk, h.live_bytes()]
    try:
        h.free(c2)
    except err_cls as e:
        log.append(type(e).__name__)
    return log


def test_symmetric_heap_matches_jax():
    assert _drive_heap(SymmetricHeap, HeapError) == \
        _drive_heap(JHeap, JHeapError)


def _drive_scheduler(sched_cls, heap_cls, pool_cls, kv_cls):
    sched = sched_cls(kv_cls(pool_cls(heap_cls(5 * 64), 64), 2, 4), 8)
    trace = collections.deque([[(8, 4), (8, 2)], [], [(8, 3)],
                               [(16, 2), (8, 1)], [(24, 8)]])
    events, t = [], 0
    while trace or not sched.idle():
        for plen, mnew in (trace.popleft() if trace else []):
            sched.submit(np.arange(1, plen + 1), mnew)
        events += [("evict", t, st.rid) for _, st in sched.step_evict()]
        events += [("admit", t, st.rid) for _, st in sched.step_admit()]
        for i in sched.active_slots():
            st = sched.slots[i]
            st.out.append(0)
            st.pos += 1
            st.done = len(st.out) >= st.max_new
        t += 1
    return events


def test_scheduler_events_match_jax():
    got = _drive_scheduler(Scheduler, SymmetricHeap, PagePool, PagedKV)
    want = _drive_scheduler(JScheduler, JHeap, JPagePool, JPagedKV)
    assert got == want and len(got) == 12


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_launch_serve_smoke_on_cpu(capsys):
    gen = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--batch", "3", "--prompt-len", "10",
                             "--tokens", "4", "--slots", "2"])
    assert gen.shape == (3, 4)
    assert "generated (3, 4)" in capsys.readouterr().out

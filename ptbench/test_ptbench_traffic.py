"""The traffic generator and the arithmetic of the end-to-end metrics."""
import numpy as np
import pytest

from ptbench import stats, traffic
from ptbench.e2e import itl_p95_ms, out_tok_s, ttft_mean_ms
from ptbench.window import Rec, Window


@pytest.mark.parametrize("mix", ["chat", "rag"])
def test_same_seed_same_requests(mix):
    m = traffic.load_mix(mix)
    a = traffic.Stream(m, 2**31 + 11, 1000)
    b = traffic.Stream(m, 2**31 + 11, 1000)
    c = traffic.Stream(m, 5, 1000)
    ra = a.first(m["concurrency"]) + \
        [next(a) for _ in range(3 * m["block"])]
    rb = b.first(m["concurrency"]) + \
        [next(b) for _ in range(3 * m["block"])]
    rc = [next(c) for _ in range(3 * m["block"])]
    assert all(np.array_equal(p, q) and n == k
               for (p, n), (q, k) in zip(ra, rb))
    assert not all(np.array_equal(p, q) for (p, _), (q, _) in
                   zip(ra[m["concurrency"]:], rc))


@pytest.mark.parametrize("mix", ["chat", "rag"])
def test_every_block_holds_the_same_lengths(mix):
    m = traffic.load_mix(mix)
    want = sorted(traffic.block_lengths(m))
    for seed in (0, 7, 2**32 + 3):
        s = traffic.Stream(m, seed, 50000)
        for _ in range(3):
            got = sorted((len(p), n) for p, n in
                         (next(s) for _ in range(m["block"])))
            assert got == want
    lens = [lp for lp, _ in want]
    outs = [lo for _, lo in want]
    assert min(lens) >= m["prompt"]["min"] and max(lens) <= m["prompt"]["max"]
    assert min(outs) >= m["output"]["min"] and max(outs) <= m["output"]["max"]
    assert max(lens) + max(outs) <= m["engine"]["max_seq"]
    assert max(lens) <= m["engine"]["prompt_bucket"]


def test_shared_prefix_and_equilibrium_start():
    m = traffic.load_mix("rag")
    s = traffic.Stream(m, 3, 32064)
    first = s.first(m["concurrency"])
    pre = first[0][0][:m["shared_prefix"]]
    assert all(np.array_equal(p[:len(pre)], pre) for p, _ in first)
    outs = [lo for _, lo in traffic.block_lengths(m)]
    res = traffic.residual_lengths(outs, 1000)
    # length-biased: the mean residual is E[o^2]/2E[o] rounded up
    want = np.mean(np.square(outs)) / (2 * np.mean(outs))
    assert abs(np.mean(res) - want) < 1.0
    assert sorted(n for _, n in first) == \
        traffic.residual_lengths(outs, m["concurrency"])


def _window(times_by_req, submits, t0, t1):
    recs = [Rec(i, s, np.zeros(4, np.int64), len(t), list(t))
            for i, (s, t) in enumerate(zip(submits, times_by_req))]
    return Window(t0=t0, t1=t1, setup_s=1.0, recs=recs, steps=[],
                  attempted=len(recs), failed=0, memory_peak_bytes=0)


def test_rate_and_tails_take_every_sample_of_the_window():
    steady = [[0.1 * k for k in range(1, 101)] for _ in range(4)]
    win = _window(steady, [0.0] * 4, 1.0, 9.0)
    # tokens at (1.0, 9.0]: steps 11..90, 80 a request
    assert out_tok_s.read(win, None) == pytest.approx(4 * 80 / 8.0)
    assert itl_p95_ms.read(win, None) == pytest.approx(100.0)
    # one stall of 2 s in one request moves the tail of the gaps only as
    # far as its share of the samples: 1 of 320 gaps
    stalled = [list(t) for t in steady]
    stalled[0] = [t + (2.0 if t > 5.0 else 0.0) for t in stalled[0]]
    win2 = _window(stalled, [0.0] * 4, 1.0, 9.0)
    assert itl_p95_ms.read(win2, None) == pytest.approx(100.0)
    # stalls in every request, in 10% of the steps, move the p95
    many = [[0.1 * k + 0.5 * (k // 10) for k in range(1, 101)]
            for _ in range(4)]
    win3 = _window(many, [0.0] * 4, 1.0, 9.0)
    assert itl_p95_ms.read(win3, None) == pytest.approx(600.0)
    assert out_tok_s.read(win3, None) < out_tok_s.read(win, None)


def test_ttft_counts_requests_submitted_inside_the_window():
    firsts = [[s + d] for s, d in zip([0.5, 1.5, 2.0, 3.0, 9.5],
                                      [9.0, 0.2, 0.4, 0.3, 0.1])]
    win = _window(firsts, [0.5, 1.5, 2.0, 3.0, 9.5], 1.0, 9.0)
    # the request at 0.5 s and the one at 9.5 s are outside the window
    assert ttft_mean_ms.read(win, None) == pytest.approx(300.0)
    assert win.first_token_waits() == pytest.approx([0.2, 0.4, 0.3])
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5

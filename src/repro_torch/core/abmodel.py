"""The paper's alpha-beta communication model (eq. 1): T_c = alpha + beta*L.

Two uses, mirroring the paper:
  * `fit()` recovers (alpha, beta^-1) with standard deviations from
    (message-size, time) samples, exactly as printed in the paper's figure
    subtitles.
  * `IciModel` predicts stage times for the TPU target (the Epiphany NoC
    constants are included for the paper-scale benchmarks), which is what
    the benchmark harness reports in its `derived` column and what the
    roofline collective term cross-checks against.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ABFit:
    alpha: float          # latency, seconds
    beta: float           # seconds / byte
    alpha_std: float
    beta_std: float

    @property
    def inv_beta(self) -> float:
        """Peak effective bandwidth (the paper's beta^-1), bytes/s."""
        return math.inf if self.beta == 0 else 1.0 / self.beta

    def time(self, nbytes: float) -> float:
        return self.alpha + self.beta * nbytes


def fit(sizes_bytes, times_s) -> ABFit:
    """Least-squares fit of T = alpha + beta*L with parameter std devs.

    Needs at least two samples at two DISTINCT sizes — a single point or
    a constant size grid cannot separate alpha from beta (the normal
    matrix is singular) and raises rather than returning garbage."""
    x = np.asarray(sizes_bytes, dtype=np.float64)
    y = np.asarray(times_s, dtype=np.float64)
    if x.ndim != 1 or x.shape != y.shape:
        raise ValueError(
            f"fit needs matching 1-D size/time samples, got shapes "
            f"{x.shape} and {y.shape}")
    if len(x) < 2:
        raise ValueError(
            f"fit needs >= 2 (size, time) samples to recover (alpha, "
            f"beta), got {len(x)}")
    if np.unique(x).size < 2:
        raise ValueError(
            f"fit needs >= 2 distinct message sizes (all samples are at "
            f"{x[0]:g} B — alpha and beta are not separable)")
    A = np.stack([np.ones_like(x), x], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    resid = y - A @ coef
    dof = max(len(x) - 2, 1)
    sigma2 = float(resid @ resid) / dof
    cov = sigma2 * np.linalg.inv(A.T @ A)
    return ABFit(
        alpha=float(coef[0]),
        beta=float(coef[1]),
        alpha_std=float(np.sqrt(cov[0, 0])),
        beta_std=float(np.sqrt(cov[1, 1])),
    )


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Per-link alpha-beta constants, congestion-aware (eq. 1 extended):

        T = alpha + hop_s * max_hops + beta * nbytes * load_eff
        load_eff = 1 + contention * (max_link_load - 1)

    ``max_link_load`` is the stage's flow multiplicity through its hottest
    physical link under XY routing (``CommPattern.max_link_load``): flows
    sharing a link serialize there, so the stage's bandwidth term scales
    with the hottest link's occupancy, not just the payload.  `contention`
    calibrates how fully they serialize (1.0 = strict serialization, 0.0 =
    the old hop-only model); :func:`fit_contention` recovers it from
    measurements the way :func:`fit` recovers (alpha, beta)."""

    alpha_s: float        # per-message launch latency
    hop_s: float          # added latency per mesh hop
    bw_Bps: float         # per-link bandwidth
    contention: float = 1.0   # fraction of hot-link serialization realized

    def time(self, nbytes: float, hops: float = 1.0,
             link_load: float = 1.0) -> float:
        load_eff = 1.0 + self.contention * (max(link_load, 1.0) - 1.0)
        return (self.alpha_s + self.hop_s * hops
                + nbytes * load_eff / self.bw_Bps)


# TPU v5e ICI: ~50 GB/s/link, ~1 us software launch, ~0.1 us/hop.
ICI_V5E = LinkModel(alpha_s=1e-6, hop_s=1e-7, bw_Bps=50e9)
# Cross-pod DCN: ~25 GB/s/host-link, tens of us latency.
DCN = LinkModel(alpha_s=20e-6, hop_s=0.0, bw_Bps=25e9)
# The paper's NoC @600MHz: put peak 2.4 GB/s, ~0.1 us put latency,
# ~1.5 clk/hop.
EPIPHANY_NOC = LinkModel(alpha_s=1e-7, hop_s=2.5e-9, bw_Bps=2.4e9)
# The paper's measured remote-read path is ~10x slower than the write path
# (Fig. 3); model the direct-get with a 10x beta penalty.
EPIPHANY_NOC_GET = LinkModel(alpha_s=1e-7, hop_s=5e-9, bw_Bps=0.24e9)


def stage_time(nbytes: float, hops: float, link: LinkModel = ICI_V5E,
               link_load: float = 1.0) -> float:
    return link.time(nbytes, hops, link_load)


def _stage3(stage) -> tuple[float, float, float]:
    """Accept both the congestion-aware (bytes, hops, load) descriptor and
    the legacy (bytes, hops) pair (load defaults to 1 — no contention)."""
    b, h, *rest = stage
    return b, h, (rest[0] if rest else 1.0)


def modeled_collective_time(stages: list[tuple],
                            link: LinkModel = ICI_V5E) -> float:
    """Sum of (nbytes, hops[, max_link_load]) stage costs — collectives
    built from ppermute stages are serialized, so stage times add."""
    return sum(link.time(*_stage3(st)) for st in stages)


def modeled_pipelined_time(stages: list[tuple], n_chunks: int,
                           link: LinkModel = ICI_V5E) -> float:
    """Chunked (double-buffered) schedule execution time (DESIGN.md §10).

    The payload of every stage is split into `n_chunks` pieces and stage k
    of chunk i overlaps stage k+1 of chunk i-1 — the e-DMA discipline of
    the paper's put pipeline.  The pipeline fills in one chunk's worth of
    stage times and drains in (C-1) repeats of the bottleneck stage:

        T(C) = sum_k t_k(b_k / C)  +  (C - 1) * max_k t_k(b_k / C)

    Each chunk pays the full per-message alpha and hop latency at every
    stage, so small messages prefer C=1 (monolithic); for large messages
    the bandwidth term dominates and T(C) ~ (S + C - 1)/(S*C) of the
    monolithic time — the classic pipelined-tree gain."""
    if n_chunks <= 1 or not stages:
        return modeled_collective_time(stages, link)
    per = [link.time(b / n_chunks, h, ld)
           for b, h, ld in map(_stage3, stages)]
    return sum(per) + (n_chunks - 1) * max(per)


def modeled_overlapped_time(stages: list[tuple], compute_s: float,
                            link: LinkModel = ICI_V5E) -> float:
    """Comm-compute overlapped schedule time (DESIGN.md §14).

    Each stage's transfer is issued non-blocking (`put_nbi`) while one
    compute block of `compute_s` seconds consumes the previously arrived
    payload — the fusion layer's double-buffer discipline.  With S stages
    there are S+1 compute blocks (the local block needs no transfer); a
    stage only extends the critical path by the part of its wire time the
    concurrent compute block fails to hide:

        T = (S + 1) * compute_s  +  sum_k max(0, t_k - compute_s)
    """
    t_comm = [link.time(*_stage3(st)) for st in stages]
    return ((len(stages) + 1) * compute_s
            + sum(max(0.0, t - compute_s) for t in t_comm))


def fit_contention(link_loads, times_s) -> float:
    """Recover the LinkModel `contention` factor from measurements of the
    SAME transfer at different hot-link multiplicities: least-squares fit
    of  t(load) = t(1) * (1 + gamma * (load - 1))  with t(1) taken from
    the load==1 samples.  Returns gamma clipped to [0, 1].

    Needs at least one load<=1 baseline sample AND at least one load>1
    sample — with no loaded point gamma is unidentifiable (the
    degenerate grid the guards below reject)."""
    loads = np.asarray(link_loads, dtype=np.float64)
    times = np.asarray(times_s, dtype=np.float64)
    if loads.ndim != 1 or loads.shape != times.shape:
        raise ValueError(
            f"fit_contention needs matching 1-D load/time samples, got "
            f"shapes {loads.shape} and {times.shape}")
    if len(loads) < 2:
        raise ValueError(
            f"fit_contention needs >= 2 (load, time) samples, got "
            f"{len(loads)}")
    base = times[loads <= 1.0]
    if len(base) == 0:
        raise ValueError("fit_contention needs at least one load==1 sample")
    if not (loads > 1.0).any():
        raise ValueError(
            "fit_contention needs at least one load>1 sample — an "
            "all-unit load grid cannot identify the contention factor")
    t1 = float(base.mean())
    x = loads - 1.0
    denom = float(x @ x)
    if denom == 0.0 or t1 <= 0.0:
        return 0.0
    gamma = float(x @ (times / t1 - 1.0)) / denom
    return min(max(gamma, 0.0), 1.0)


def choose_chunks(stages: list[tuple],
                  link: LinkModel = ICI_V5E, max_chunks: int = 32,
                  tuner=None, key: tuple | None = None) -> int:
    """Pick the chunk count (power of two, 1 = monolithic) minimizing the
    modeled pipelined time of a schedule's (bytes, hops[, max_link_load])
    stage costs.

    With a `tuner` (a ``repro_torch.core.tuner.TunedSelector``) and a
    `key` ``(collective, algorithm, n, nbytes, topo)``, the MEASURED best
    chunk count for that point is consulted first (DESIGN.md §13
    precedence); the analytic pipeline model is the fallback for
    unmeasured points."""
    if tuner is not None and key is not None:
        collective, algorithm, n, nbytes, topo = key
        c = tuner.chunks(collective, algorithm, n, nbytes, topo,
                         max_chunks=max_chunks)
        if c is not None:
            return max(1, min(int(c), max_chunks))
    candidates = [1 << k for k in range(max(1, max_chunks).bit_length())
                  if (1 << k) <= max_chunks]
    return min(candidates,
               key=lambda c: modeled_pipelined_time(stages, c, link))

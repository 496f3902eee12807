"""Measured-performance autotuner — closes the selection loop (port of
`repro/core/tuner.py`, DESIGN.md §13).

The analytic :class:`~repro_torch.core.abmodel.LinkModel` selects
algorithms, chunk counts and embeddings; measured bandwidth and latency
diverge from such a model once contention and runtime overheads enter.
This module keeps a persistent database of MEASURED collective times and
lets measurements override the model:

  * :class:`TuningDB` — JSON-on-disk store keyed by topology fingerprint
    x collective x team shape x payload-size bucket (power of two); each
    point holds per-variant ``(algorithm, chunks, embedding)`` running
    means.  ``best()`` is the measured argmin.  The file format is the
    reference's: a DB written by either package loads in the other.
  * :class:`Tuner` — fills the DB: ``tune(ctx, grid)`` runs an offline
    calibration sweep on a SIM context (every candidate variant measured
    with ``profile.measure``, which waits for the card, ALWAYS including
    the analytic selector's own pick); ``observe(sample)`` refines online
    from profiler samples (attach via ``Profiler.add_sink``); and
    ``refit_link`` recovers the LinkModel's alpha/beta (``abmodel.fit``)
    and contention (``fit_contention``) from single-stage measurements —
    on the card, the SIM net's own constants.
  * :class:`TunedSelector` — what ``choose_algorithm`` /
    ``choose_schedule`` / ``choose_chunks`` / ``choose_embedding`` /
    ``fusion.choose_attention`` consult FIRST (the ``tuner=`` parameter);
    a miss falls back to the analytic model.  Lookups are restricted to
    the caller's candidate set.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Sequence

from . import abmodel
from .profile import OpSample, Profiler, _emb_str, measure

# Payload-size buckets are powers of two: measurements at 6000 B and
# 8000 B land in the same 8192 B bucket — message-size sensitivity below
# a factor of sqrt(2) is noise on real substrates.
def nbytes_bucket(nbytes: float) -> int:
    if nbytes <= 1:
        return 1
    return 1 << int(round(math.log2(float(nbytes))))


def fingerprint(topo, n_pes: int, dead_pes=()) -> str:
    """Topology identity the DB keys on.  Deliberately EXCLUDES the
    backend class: a DB calibrated on the SIM oracle for a given mesh is
    the prior the SPMD run on the same mesh inherits (the warm-then-
    train flow); the DB file itself is per-machine.

    `dead_pes` marks a DEGRADED mesh (DESIGN.md §17): a 4x4 mesh with
    PE 5 dead is a different machine than the full mesh — its snake
    embedding detours, its link loads shift — so measurements under the
    two keys never blend, and the elastic restart path re-tunes under
    the degraded key instead of replaying full-mesh winners."""
    dead = ",".join(str(int(p)) for p in sorted(set(dead_pes)))
    suffix = f":dead{dead}" if dead else ""
    if topo is None or getattr(topo, "n_pes", None) != n_pes:
        return f"flat:n{n_pes}{suffix}"
    t = "".join("1" if w else "0" for w in topo._torus())
    c = ",".join(f"{x:g}" for x in topo._cost())
    return f"mesh{'x'.join(map(str, topo.shape))}:t{t}:c{c}{suffix}"


def variant_key(algorithm: str, chunks: int, embedding=None) -> str:
    return f"{algorithm}|c{int(chunks)}|{_emb_str(embedding)}"


def split_variant(vkey: str) -> tuple[str, int, str]:
    algo, c, emb = vkey.split("|", 2)
    return algo, int(c[1:]), emb


# Online refinement keeps a running mean with the effective sample count
# capped, so a drifting substrate (thermal throttling, a busy host) can
# move the mean instead of being averaged away.
MEAN_CAP = 32


class TuningDB:
    """Persistent measured-performance store (JSON round-trip).

    ``entries[key]["variants"][vkey] = {"mean_s", "n", "predicted_s",
    "live_mean_s", "live_n"}`` with ``key = fp|collective|team|bucket``;
    ``links[fp]`` holds a refitted LinkModel's constants.

    Two measurement methodologies land here and must not blend:
    CALIBRATED times (``source="cal"``, the sweep's steady-state timer)
    and LIVE times (``source="live"``, online refinement from one-call
    execution samples, which include per-call dispatch and device-wait
    overhead).  Each variant keeps both
    running means; at any grid point ``best()`` compares calibrated
    means when any variant has calibrated data, and falls back to live
    means only on points the sweep never covered — so online samples
    refine uncovered points without corrupting calibrated picks."""

    def __init__(self):
        self.entries: dict[str, dict] = {}
        self.links: dict[str, dict] = {}

    @staticmethod
    def key(fp: str, collective: str, team: str, nbytes: float) -> str:
        return f"{fp}|{collective}|{team}|{nbytes_bucket(nbytes)}"

    def record(self, fp: str, collective: str, team: str, nbytes: float,
               algorithm: str, chunks: int, embedding=None,
               measured_s: float = 0.0, predicted_s=None,
               source: str = "cal") -> None:
        if not algorithm or measured_s <= 0.0:
            return
        k = self.key(fp, collective, team, nbytes)
        e = self.entries.setdefault(k, {"variants": {}})
        vk = variant_key(algorithm, chunks, embedding)
        v = e["variants"].setdefault(
            vk, {"mean_s": 0.0, "n": 0, "predicted_s": None,
                 "live_mean_s": 0.0, "live_n": 0})
        v.setdefault("live_mean_s", 0.0)     # older DB files on disk
        v.setdefault("live_n", 0)
        mean_k, n_k = ("mean_s", "n") if source == "cal" \
            else ("live_mean_s", "live_n")
        n = min(v[n_k] + 1, MEAN_CAP)
        v[mean_k] += (measured_s - v[mean_k]) / n
        v[n_k] = v[n_k] + 1
        # NaN-free on disk: json.dump would emit an invalid literal
        if predicted_s is not None and predicted_s == predicted_s:
            v["predicted_s"] = float(predicted_s)

    def variants(self, fp: str, collective: str, team: str,
                 nbytes: float) -> dict[str, dict] | None:
        e = self.entries.get(self.key(fp, collective, team, nbytes))
        return None if e is None else e["variants"]

    def best(self, fp: str, collective: str, team: str, nbytes: float,
             algos: Sequence[str] | None = None,
             max_chunks: int | None = None,
             widen: int = 0) -> tuple[str, int, str, float] | None:
        """Measured argmin ``(algorithm, chunks, embedding, mean_s)``
        among the variants matching the caller's constraints, or None
        (unmeasured point -> the caller falls back to the analytic
        model).  Calibrated means take precedence per grid point (see
        the class docstring); ``widen`` > 0 also searches +-widen
        neighboring size buckets (nearest first) when the exact bucket
        is empty."""
        b = nbytes_bucket(nbytes)
        buckets = [b]
        for i in range(1, widen + 1):
            buckets += [b << i, max(b >> i, 1)]
        for bk in buckets:
            e = self.entries.get(f"{fp}|{collective}|{team}|{bk}")
            if e is None:
                continue
            cal, live = [], []
            for vk, v in e["variants"].items():
                algo, chunks, emb = split_variant(vk)
                if algos is not None and algo not in algos:
                    continue
                if max_chunks is not None and chunks > max_chunks:
                    continue
                if v["n"] > 0:
                    cal.append((v["mean_s"], algo, chunks, emb))
                elif v.get("live_n", 0) > 0:
                    live.append((v["live_mean_s"], algo, chunks, emb))
            cands = cal or live
            if cands:
                t, algo, chunks, emb = min(cands)
                return algo, chunks, emb, t
        return None

    # -- refitted link models -------------------------------------------------
    def set_link(self, fp: str, link: abmodel.LinkModel) -> None:
        self.links[fp] = {"alpha_s": link.alpha_s, "hop_s": link.hop_s,
                          "bw_Bps": link.bw_Bps,
                          "contention": link.contention}

    def link_model(self, fp: str) -> abmodel.LinkModel | None:
        got = self.links.get(fp)
        return None if got is None else abmodel.LinkModel(**got)

    # -- persistence ----------------------------------------------------------
    def to_json(self) -> dict:
        return {"schema": 1, "entries": self.entries, "links": self.links}

    @classmethod
    def from_json(cls, doc: dict) -> "TuningDB":
        db = cls()
        db.entries = dict(doc.get("entries", {}))
        db.links = dict(doc.get("links", {}))
        return db

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path) -> "TuningDB":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def __len__(self) -> int:
        return len(self.entries)


class TunedSelector:
    """The measured-first selection surface ``choose_*`` consult before
    pricing anything with the analytic model (DESIGN.md §13 precedence:
    measured best -> refitted model -> prior constants)."""

    def __init__(self, db: TuningDB, team: str | None = None,
                 fingerprint: str | None = None):
        self.db = db
        self._team = team
        # Explicit fingerprint override (DESIGN.md §17): the elastic path
        # pins the degraded-mesh key so lookups stop resolving against
        # full-mesh measurements.  None = derive from (topo, n) per call.
        self._fp = fingerprint

    def with_fingerprint(self, fp: str) -> "TunedSelector":
        """A copy of this selector keyed to `fp` — what
        ``ShmemContext.refingerprint`` swaps in after mesh degradation."""
        return TunedSelector(self.db, team=self._team, fingerprint=fp)

    def _t(self, n: int, team: str | None = None) -> str:
        return team or self._team or f"n{n}"

    def _fp_of(self, topo, n: int) -> str:
        return self._fp if self._fp is not None else fingerprint(topo, n)

    def algorithm(self, collective: str, n: int, nbytes: float, topo=None,
                  candidates: Sequence[str] | None = None,
                  team: str | None = None) -> str | None:
        got = self.db.best(self._fp_of(topo, n), collective,
                           self._t(n, team), nbytes, algos=candidates)
        return None if got is None else got[0]

    def schedule(self, collective: str, n: int, nbytes: float, topo=None,
                 algos: Sequence[str] | None = None,
                 max_chunks: int | None = None,
                 team: str | None = None) -> tuple[str, int] | None:
        got = self.db.best(self._fp_of(topo, n), collective,
                           self._t(n, team), nbytes, algos=algos,
                           max_chunks=max_chunks)
        return None if got is None else (got[0], got[1])

    def chunks(self, collective: str, algorithm: str, n: int, nbytes: float,
               topo=None, max_chunks: int | None = None,
               team: str | None = None) -> int | None:
        """Measured-best chunk count FOR the already-chosen algorithm —
        a best variant under a different algorithm says nothing about
        this one's pipelining, so it is a miss."""
        got = self.db.best(self._fp_of(topo, n), collective,
                           self._t(n, team), nbytes, algos=[algorithm],
                           max_chunks=max_chunks)
        return None if got is None else got[1]

    def embedding(self, n: int, nbytes: float, topo=None,
                  collective: str = "allreduce",
                  team: str | None = None):
        """"identity" when the measured best runs un-embedded, the
        winning order/"snake" when it runs embedded, None on a miss.
        Searches +-2 neighboring size buckets: embedding selection keys
        on a representative payload (``EMBED_REF_BYTES``) that a sweep
        grid need not contain exactly."""
        got = self.db.best(self._fp_of(topo, n), collective,
                           self._t(n, team), nbytes, widen=2)
        if got is None:
            return None
        algo, _, emb, _ = got
        if algo != "ring_emb":
            return "identity"
        if emb in ("", "snake"):
            return "snake"
        if emb.startswith("perm:"):
            return tuple(int(p) for p in emb[5:].split(","))
        return "identity"


# Default offline-calibration grid: small enough for CI smoke, wide
# enough to cover the rd/ring/ring_emb cross-overs on a 16-PE mesh.
DEFAULT_GRID: dict[str, Any] = {
    "collectives": ("allreduce", "fcollect"),
    "sizes": (256, 4096, 65536),
    "chunks": (1, 4),
    "iters": 5,
    "warmup": 2,
}


class Tuner:
    """Owns a :class:`TuningDB` plus the loops that fill it.

    ``link`` is the prior :class:`~repro_torch.core.abmodel.LinkModel`
    (defaults to ``abmodel.ICI_V5E``, the cost model's default); after
    ``refit_link`` the DB holds the substrate's own fitted constants and
    :meth:`link_model` returns them."""

    def __init__(self, db: TuningDB | None = None, path=None,
                 link: abmodel.LinkModel | None = None):
        self.path = path
        if db is None and path is not None and os.path.exists(path):
            db = TuningDB.load(path)
        self.db = db if db is not None else TuningDB()
        self.link = link if link is not None else abmodel.ICI_V5E

    def selector(self) -> TunedSelector:
        return TunedSelector(self.db)

    def save(self, path=None) -> None:
        target = path or self.path
        if target is None:
            raise ValueError("no path: pass save(path=...) or construct "
                             "Tuner(path=...)")
        self.db.save(target)

    def link_model(self, topo, n_pes: int) -> abmodel.LinkModel:
        """The refitted LinkModel for this topology when one has been
        calibrated, else the prior."""
        got = self.db.link_model(fingerprint(topo, n_pes))
        return got if got is not None else self.link

    # -- online refinement (profiler sink) -----------------------------------
    def observe(self, sample: OpSample) -> None:
        """Refine the DB from one profiler sample — recorded as a LIVE
        measurement (eager dispatch-inclusive timing; the DB keeps it
        separate from calibrated sweep means, see :class:`TuningDB`).
        Skipped: traced samples (their wall time is capture time),
        "measure"-kind samples (``tune`` records those itself as
        calibrated — observing them too would double-count), and samples
        with no resolved algorithm or no fingerprint (attach the
        profiler through ``ShmemContext(profile=..., tuner=...)`` so ops
        carry one)."""
        if (sample.traced or sample.wall_s <= 0.0 or not sample.algorithm
                or sample.kind != "collective"
                or not getattr(sample, "fingerprint", "")
                or not sample.n_pes):
            return
        emb = sample.embedding or None
        self.db.record(sample.fingerprint, sample.collective, sample.team,
                       sample.nbytes, sample.algorithm, sample.chunks,
                       emb, sample.wall_s, sample.predicted_s,
                       source="live")

    # -- offline calibration --------------------------------------------------
    def _variants(self, collective: str, n: int, nbytes: float, topo, link,
                  chunk_grid: Sequence[int]):
        """The candidate (algorithm, chunks, embedding) variants for one
        grid point — every legal algorithm x the chunk grid, PLUS the
        analytic selector's own (algorithm, chunks) pick, so the sweep
        always covers what the model would have run."""
        from . import collectives as coll
        algos = ["ring"] + (["rd"] if n & (n - 1) == 0 else [])
        emb_order = None
        if topo is not None and getattr(topo, "n_pes", None) == n:
            snake = topo.snake_order()
            if snake != tuple(range(n)):
                emb_order = snake
                algos.append("ring_emb")
        out = []
        for algo in algos:
            for c in chunk_grid:
                out.append((algo, int(c),
                            emb_order if algo == "ring_emb" else None))
        if collective in coll._SELECTABLE:
            a, c = coll.choose_schedule(n, nbytes, topo, link,
                                        collective=collective)
            pick = (a, c, emb_order if a == "ring_emb" else None)
            if pick not in out:
                out.append(pick)
        return out

    def tune(self, ctx, grid: dict | None = None) -> dict:
        """Offline calibration sweep on a :class:`ShmemContext` (the SIM
        backend is the substrate — single-process, deterministic, on the
        context's device).  Measures every variant of every
        (collective, size) grid point with the shared warmup timer
        (:func:`~repro_torch.core.profile.measure`), records the
        results, refits the link model, and returns a summary
        ``{fingerprint, points, variants, best}``."""
        import numpy as np
        import torch
        from . import collectives as coll
        from .netops import SimNetOps

        if not isinstance(ctx.net, SimNetOps):
            raise ValueError("tune() calibrates on the SIM backend "
                             "(sim_ctx); SPMD runs inherit the DB by "
                             "topology fingerprint")
        g = dict(DEFAULT_GRID)
        g.update(grid or {})
        n = ctx.n_pes
        topo = ctx.topo
        link = self.link_model(topo, n)
        fp = fingerprint(topo, n)
        team = f"n{n}"
        prof: Profiler | None = getattr(ctx, "profile", None)

        def payload(nbytes: float):
            w = max(1, int(nbytes) // 4)
            return torch.as_tensor(np.random.RandomState(0)
                                   .randn(n, w).astype(np.float32),
                                   device=ctx.device)

        runners = {
            "allreduce": lambda v, algo, c, emb: coll.allreduce(
                ctx.net, v, "sum", algorithm=algo, pipeline_chunks=c,
                topo=topo, link=link, embedding=emb),
            "fcollect": lambda v, algo, c, emb: coll.fcollect(
                ctx.net, v, algorithm=algo, pipeline_chunks=c,
                topo=topo, link=link, embedding=emb),
        }
        points = variants = 0
        best: dict[str, str] = {}
        for collective in g["collectives"]:
            run = runners[collective]
            build = coll._SELECTABLE[collective]
            for nbytes in g["sizes"]:
                x = payload(nbytes)
                for algo, c, emb in self._variants(collective, n, nbytes,
                                                   topo, link, g["chunks"]):
                    sched = build(n, nbytes, algorithm=algo,
                                  embedding=emb if algo == "ring_emb"
                                  else None)
                    pred = sched.pipelined_time(c, topo, link)
                    t = measure(
                        lambda v, _a=algo, _c=c, _e=emb: run(v, _a, _c, _e),
                        x, warmup=g["warmup"], iters=g["iters"],
                        profile=prof, collective=collective,
                        nbytes=float(nbytes), n_pes=n, team=team,
                        algorithm=algo, chunks=c, embedding=emb,
                        schedule=sched.name, predicted_s=pred,
                        fingerprint=fp)
                    self.db.record(fp, collective, team, nbytes, algo, c,
                                   emb, t, pred)
                    variants += 1
                points += 1
                got = self.db.best(fp, collective, team, nbytes)
                best[f"{collective}@{nbytes_bucket(nbytes)}B"] = \
                    variant_key(got[0], got[1], got[2] or None)
        self.refit_link(ctx, sizes=tuple(g["sizes"]))
        if self.path is not None:
            self.save()
        return {"fingerprint": fp, "points": points, "variants": variants,
                "best": best}

    def refit_link(self, ctx, sizes: Sequence[float] = (256, 4096, 65536)
                   ) -> abmodel.LinkModel:
        """Recover the substrate's own LinkModel from single-stage
        measurements — the generalization of the paper's Fig. 3
        methodology (``abmodel.fit``) plus the congestion calibration
        (``fit_contention``), stored per topology fingerprint so tuned
        AND analytic pricing both use measured constants."""
        import numpy as np
        import torch
        from .pattern import ring_pattern

        def payload(seed: int, s: int):
            return torch.as_tensor(np.random.RandomState(seed)
                                   .randn(n, max(1, s // 4))
                                   .astype(np.float32), device=ctx.device)

        n = ctx.n_pes
        topo = ctx.topo
        ring = ring_pattern(n)
        sizes = sorted({max(4, int(s)) for s in sizes})
        if len(sizes) < 2:
            sizes = sorted({sizes[0], sizes[0] * 16})
        times = []
        for s in sizes:
            x = payload(1, s)
            times.append(measure(lambda v: ctx.net.ppermute(v, ring), x))
        ab = abmodel.fit(sizes, times)
        prior = self.link_model(topo, n)
        contention = prior.contention
        if topo is not None and getattr(topo, "n_pes", None) == n:
            # the SAME payload through patterns of different hot-link
            # multiplicity: the snake-embedded ring is the load<=1
            # baseline where one exists, the logical ring and a
            # column-funnel offset supply loaded points
            s = sizes[-1]
            x = payload(2, s)
            pats = [ring, ring_pattern(n, n // 2 or 1)]
            snake = topo.snake_order()
            if snake != tuple(range(n)):
                pats.append(ring.relabel(snake, n))
            loads, tms = [], []
            for p in pats:
                loads.append(p.max_link_load(topo))
                tms.append(measure(lambda v, _p=p: ctx.net.ppermute(v, _p),
                                   x))
            try:
                contention = abmodel.fit_contention(loads, tms)
            except ValueError:
                pass                      # no load<=1 baseline on this mesh
        fitted = abmodel.LinkModel(
            alpha_s=max(ab.alpha, 1e-9), hop_s=prior.hop_s,
            bw_Bps=max(ab.inv_beta, 1.0), contention=contention)
        self.db.set_link(fingerprint(topo, n), fitted)
        return fitted

"""Synthetic token pipeline with host-side prefetch (port of
`repro/data/pipeline.py`, numpy only).

Deterministic per (seed, step): any batch can be made again after a
restart without coordination.  Batches are numpy arrays; the train step
moves them to its device.  `iterate` keeps a bounded prefetch queue
filled by a background thread ahead of the training loop.

One departure from the reference: its `SyntheticLM` draws a vision
config's frontend embeds at width 1 (it has no argument for their
width), which its model cannot take (`forward` concatenates them with
(B, L - nf, d_model) embeddings).  The port's takes `frontend_dim`, whose
default keeps that rule, and `make_pipeline` and the train launcher pass
d_model (`frontend_kwargs`), the width `input_specs` gives.  The embeds
are the batch's last draw, so tokens and targets stay the reference's.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Zipf-ish token stream with next-token targets; the batches of
    `repro.data.pipeline.SyntheticLM` bit for bit."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, frames_dim: int | None = None,
                 frontend_tokens: int = 0, frontend_dim: int | None = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.frames_dim = frames_dim
        self.frontend_tokens = frontend_tokens
        self.frontend_dim = frontend_dim

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        # zipf-flavored ids, clipped into vocab
        raw = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
        toks = (raw % (self.vocab - 2)) + 1
        out = {}
        if self.frames_dim is not None:
            out["frames"] = rng.standard_normal(
                (self.global_batch, self.seq_len, self.frames_dim),
                dtype=np.float32).astype(np.float32)
            out["targets"] = toks[:, :self.seq_len].astype(np.int32)
            return out
        out["tokens"] = toks[:, :self.seq_len].astype(np.int32)
        out["targets"] = toks[:, 1:].astype(np.int32)
        if self.frontend_tokens:
            # the reference's width is 1 (frames_dim is None here)
            width = 1 if self.frontend_dim is None else self.frontend_dim
            out["frontend_embeds"] = rng.standard_normal(
                (self.global_batch, self.frontend_tokens, width),
                dtype=np.float32)
        return out

    def iterate(self, start_step: int = 0, prefetch: int = 2
                ) -> Iterator[dict]:
        """Batches from `start_step` on, made `prefetch` ahead by a
        thread that stops when the generator is closed."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set():
                item = self.batch(s)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            t.join(timeout=5)


def frontend_kwargs(cfg) -> dict:
    """`SyntheticLM`'s frontend arguments for `cfg`: frames of d_model for
    the audio frontend, n_frontend_tokens embeds of d_model for the vision
    one (the reference passes no width for those, see the module's
    docstring)."""
    return dict(
        frames_dim=cfg.d_model if cfg.frontend == "audio" else None,
        frontend_tokens=(cfg.n_frontend_tokens
                         if cfg.frontend == "vision" else 0),
        frontend_dim=cfg.d_model if cfg.frontend == "vision" else None)


def make_pipeline(cfg, shape: str, seed: int = 0) -> SyntheticLM:
    """The pipeline of a shape cell (`models.config.SHAPES`) for `cfg`."""
    from ..models.config import SHAPES
    s = SHAPES[shape]
    return SyntheticLM(vocab=cfg.vocab, seq_len=s["seq_len"],
                       global_batch=s["global_batch"], seed=seed,
                       **frontend_kwargs(cfg))

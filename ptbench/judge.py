"""How `correct` is decided for a served model: the served tokens of a
sample of the window's finished requests against the plain reference.

The sample, drawn from the run's seed, holds the request with the most
served tokens and `check_requests` - 1 others.  The family's reference
(`ref/<family>.py`) runs once over each prompt with its served tokens
(teacher-forced) and gives, at each served position, float32 logits over
the whole vocabulary.  The number compared is the widest gap by which a
served token's logit lies below the reference's best at its position: 0
where the program picked the reference's argmax, small where bf16
rounding flipped a near tie, large where a token is wrong.

The control is judged the same way, in the program's place: at the same
positions, the tokens that the reference computed in float8 puts first
are the served ones (`sides=("program", "control")`)."""
from __future__ import annotations

import numpy as np
import torch

from .traffic import seed_bits

SAMPLE_STREAM = 0x5eed


def sample(finished: list, k: int, seed: int) -> list:
    """The longest finished request (most served tokens, then the longest
    prompt, then the first) and k - 1 others drawn from the seed."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: (
        -len(finished[i].tokens), -len(finished[i].prompt), i))
    rest = order[1:]
    rng = np.random.default_rng([seed_bits(seed), SAMPLE_STREAM])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [finished[order[0]]] + [finished[rest[i]] for i in sorted(pick)]


def request_gaps(ref, w: dict, arch: dict, prompt, tokens, device, *,
                 sides=("program",)) -> dict:
    """Per served token of one request, each side's gap: the program's
    served tokens, and the control's float8 argmax."""
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(tokens[:-1], np.int64)])
    seq = torch.from_numpy(seq).to(device)
    first = len(prompt) - 1
    logits = ref.logits(w, arch, seq, first)
    best = logits.max(-1).values
    picks = {"program": lambda: torch.as_tensor(
        np.asarray(tokens, np.int64), device=device),
             "control": lambda: ref.logits(w, arch, seq, first,
                                           fp8=True).argmax(-1)}
    return {s: (best - logits.gather(1, picks[s]()[:, None])[:, 0]).cpu()
            for s in sides}


def judge(ref, w: dict, arch: dict, finished: list, k: int, seed: int,
          device, limit: float, *, sides=("program",)) -> dict:
    """Each side's checks: {"widest_gap": {"value", "limit"},
    "tokens_checked", "requests_checked"}, judged by `passed`."""
    widest = {s: [] for s in sides}
    n_tok = 0
    chosen = sample(finished, k, seed)
    for rec in chosen:
        g = request_gaps(ref, w, arch, rec.prompt, rec.tokens, device,
                         sides=sides)
        for s in sides:
            widest[s].append(float(g[s].max()))
        n_tok += len(rec.tokens)
    return {s: {"widest_gap": {"value": max(v) if v else float("inf"),
                               "limit": limit},
                "tokens_checked": {"value": n_tok, "limit": 1},
                "requests_checked": {"value": len(chosen), "limit": 1}}
            for s, v in widest.items()}


def passed(checks: dict) -> bool:
    """Every served token within the gap limit, and something checked."""
    return (checks["widest_gap"]["value"] <= checks["widest_gap"]["limit"]
            and checks["tokens_checked"]["value"] >= 1)

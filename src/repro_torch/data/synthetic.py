"""Deterministic synthetic LM data — the port's copy of
``repro/data/synthetic.py::lm_batches`` (numpy only, so the same seed gives
the same tokens in both packages).  The GLUE-like tasks come with the
encoder slice."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def lm_batches(
    vocab: int,
    batch: int,
    seq: int,
    *,
    seed: int = 0,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {tokens (B,S+1)} with planted bigram structure."""
    base = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    # a sparse "grammar": each token strongly predicts one of 8 successors
    succ = base.integers(0, vocab, size=(vocab, 8))
    step = start_step
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=batch)
        noise = rng.random((batch, seq))
        pick = rng.integers(0, 8, size=(batch, seq))
        rand = rng.integers(0, vocab, size=(batch, seq))
        for t in range(seq):
            nxt = succ[toks[:, t], pick[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.8, nxt, rand[:, t])
        yield {"tokens": toks}
        step += 1

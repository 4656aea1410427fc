"""Deterministic synthetic data — the port's copy of
``repro/data/synthetic.py`` (numpy only, so the same seed gives the same
examples, labels and batch order in both packages).

* :func:`lm_batches` — language-model token streams with planted bigram
  structure.
* :class:`GlueTask` — eight classification/regression tasks mirroring the
  paper's GLUE subset in *format* (single- vs paired-sentence, #classes,
  metric, train-set size), with a planted decision rule on latent "topic"
  token blocks plus token-level noise.

A task's streams are seeded by ``hash(task name)`` as in the reference, so
two processes agree only under the same ``PYTHONHASHSEED``; within one
process both packages give the same examples.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

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


# ---------------------------------------------------------------------------
# GLUE-like tasks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    paired: bool  # two-segment input?
    n_classes: int  # 1 → regression
    metric: str  # accuracy | f1 | matthews | pearson
    train_size: int
    eval_size: int
    noise: float  # label-flip / jitter probability (task difficulty)


# mirrors paper §4.1: min(10000, |train|) examples; RTE is the small one.
GLUE_TASKS: Dict[str, TaskSpec] = {
    "mnli": TaskSpec("mnli", True, 3, "accuracy", 10000, 2000, 0.12),
    "sst2": TaskSpec("sst2", False, 2, "accuracy", 10000, 1000, 0.06),
    "mrpc": TaskSpec("mrpc", True, 2, "f1", 3668, 800, 0.10),
    "cola": TaskSpec("cola", False, 2, "matthews", 8551, 1000, 0.20),
    "qnli": TaskSpec("qnli", True, 2, "accuracy", 10000, 1500, 0.08),
    "qqp": TaskSpec("qqp", True, 2, "accuracy", 10000, 2000, 0.09),
    "rte": TaskSpec("rte", True, 2, "accuracy", 2490, 500, 0.18),
    "stsb": TaskSpec("stsb", True, 1, "pearson", 5749, 800, 0.08),
}

_CLS, _SEP = 0, 1
_N_TOPICS = 16


class GlueTask:
    """Deterministic synthetic task in GLUE format.

    Examples are (tokens (S,), label).  The latent rule:

    * single-segment: class = topic-block majority (with noise) → learnable
      from token identity patterns (SST-2/CoLA style).
    * paired: class depends on topic agreement between the two segments
      (+ for MNLI a 'contradiction' topic pairing); STS-B regresses the
      topic-overlap fraction.
    """

    def __init__(self, spec: TaskSpec, vocab: int, seq: int, seed: int = 0):
        self.spec, self.vocab, self.seq, self.seed = spec, vocab, seq, seed
        root = np.random.default_rng(
            np.random.SeedSequence([hash(spec.name) % (2**31), seed])
        )
        # each topic owns a disjoint-ish token bank
        self.topic_tokens = root.integers(2, vocab, size=(_N_TOPICS, 64))

    # -- example generator --------------------------------------------------
    def _segment(self, rng, topic: int, length: int) -> np.ndarray:
        bank = self.topic_tokens[topic]
        sig = rng.choice(bank, size=length)
        noise_mask = rng.random(length) < 0.5
        noise = rng.integers(2, self.vocab, size=length)
        return np.where(noise_mask, noise, sig)

    def example(self, split: str, i: int) -> Tuple[np.ndarray, float]:
        spec = self.spec
        rng = np.random.default_rng(
            np.random.SeedSequence(
                [hash(spec.name) % (2**31), self.seed, 0 if split == "train" else 1, i]
            )
        )
        S = self.seq
        toks = np.full(S, _SEP, np.int32)
        toks[0] = _CLS
        if not spec.paired:
            topic = int(rng.integers(0, _N_TOPICS))
            label = topic % spec.n_classes
            seg = self._segment(rng, topic, S - 2)
            toks[1 : S - 1] = seg
        else:
            t1 = int(rng.integers(0, _N_TOPICS))
            same = bool(rng.random() < 0.5)
            if spec.n_classes == 3 and not same:
                # contradiction vs neutral: paired topic t1^1 = contradiction
                contra = bool(rng.random() < 0.5)
                t2 = (t1 ^ 1) if contra else int((t1 + 2 + rng.integers(0, _N_TOPICS - 3)) % _N_TOPICS)
                label = 2 if contra else 1
            else:
                t2 = t1 if same else int((t1 + 1 + rng.integers(0, _N_TOPICS - 1)) % _N_TOPICS)
                label = 0 if same else 1
                if spec.n_classes == 3:
                    label = 0
            half = (S - 3) // 2
            toks[1 : 1 + half] = self._segment(rng, t1, half)
            toks[1 + half] = _SEP
            toks[2 + half : 2 + 2 * half] = self._segment(rng, t2, half)
            if spec.n_classes == 1:  # stsb: regression on overlap fraction
                mix = rng.random()
                m = int(mix * half)
                toks[2 + half : 2 + half + m] = self._segment(rng, t1, m)
                label = 5.0 * (1.0 - mix) if not same else 5.0 * (1 - 0.5 * mix)
        # label noise
        if spec.n_classes > 1 and rng.random() < spec.noise:
            label = int(rng.integers(0, spec.n_classes))
        elif spec.n_classes == 1:
            label = float(np.clip(label + rng.normal() * spec.noise * 5, 0, 5))
        return toks, float(label)

    def batches(
        self, split: str, batch: int, *, epochs: int = 1, limit: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        n = min(
            limit or 10**9,
            self.spec.train_size if split == "train" else self.spec.eval_size,
        )
        order_rng = np.random.default_rng(np.random.SeedSequence([self.seed, 99]))
        for ep in range(epochs):
            idx = np.arange(n)
            if split == "train":
                order_rng.shuffle(idx)
            for s in range(0, n - batch + 1, batch):
                rows = [self.example(split, int(j)) for j in idx[s : s + batch]]
                toks = np.stack([r[0] for r in rows])
                labels = np.array([r[1] for r in rows], np.float32)
                yield {"tokens": toks, "labels": labels}


def make_task(name: str, vocab: int = 50265, seq: int = 64, seed: int = 0) -> GlueTask:
    return GlueTask(GLUE_TASKS[name], vocab, seq, seed)

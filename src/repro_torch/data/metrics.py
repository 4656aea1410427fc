"""GLUE metrics (numpy; evaluation is host-side) — the port's copy of
``repro/data/metrics.py``."""
from __future__ import annotations

import numpy as np


def accuracy(pred: np.ndarray, label: np.ndarray) -> float:
    return float((pred == label).mean())


def f1_binary(pred: np.ndarray, label: np.ndarray) -> float:
    tp = float(((pred == 1) & (label == 1)).sum())
    fp = float(((pred == 1) & (label == 0)).sum())
    fn = float(((pred == 0) & (label == 1)).sum())
    if tp == 0:
        return 0.0
    p, r = tp / (tp + fp), tp / (tp + fn)
    return 2 * p * r / (p + r)


def matthews_corr(pred: np.ndarray, label: np.ndarray) -> float:
    tp = float(((pred == 1) & (label == 1)).sum())
    tn = float(((pred == 0) & (label == 0)).sum())
    fp = float(((pred == 1) & (label == 0)).sum())
    fn = float(((pred == 0) & (label == 1)).sum())
    den = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / den) if den > 0 else 0.0


def pearson_corr(pred: np.ndarray, label: np.ndarray) -> float:
    p = pred - pred.mean()
    l = label - label.mean()
    den = np.sqrt((p**2).sum() * (l**2).sum())
    return float((p * l).sum() / den) if den > 0 else 0.0


def compute(metric: str, pred: np.ndarray, label: np.ndarray) -> float:
    return {
        "accuracy": accuracy,
        "f1": f1_binary,
        "matthews": matthews_corr,
        "pearson": pearson_corr,
    }[metric](pred, label)

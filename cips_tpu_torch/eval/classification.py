"""Classifier evaluation: accuracy, precision, recall, F1 and AUC, the compact
summary row and the confusion matrix (port of cips_tpu/eval/classification.py).

The JAX package computes the five metrics with scikit-learn; the card's
machine has none, so this module computes them in numpy with scikit-learn's
definitions for binary labels (positive class 1): precision, recall and F1
are 0 where their denominator is 0 (``zero_division=0``); AUC is the rank
statistic of the positives' class-1 probabilities, tied scores sharing their
mean rank (what the area under the trapezoidal ROC curve equals), and NaN when
the labels hold a single class. The confusion-matrix figure needs matplotlib
and is skipped (None) without it, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def softmax_np(logits: np.ndarray) -> np.ndarray:
    """Row-wise softmax in float64."""
    logits = np.asarray(logits, np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    return probs / probs.sum(-1, keepdims=True)


def _ratio(num: int, den: int) -> float:
    return num / den if den else 0.0


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve of binary ``labels`` by ``scores``: the rank
    statistic (Mann-Whitney U / (n_pos n_neg)) with ties at their mean rank;
    NaN when only one class is present."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, np.float64)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(scores.size, np.float64)
    start = 0
    for end in range(1, scores.size + 1):  # runs of tied scores share their mean rank (1-based)
        if end == scores.size or sorted_scores[end] != sorted_scores[start]:
            ranks[order[start:end]] = (start + end + 1) / 2.0
            start = end
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def classification_metrics(labels: np.ndarray, logits: np.ndarray) -> Dict[str, float]:
    """accuracy, precision, recall, f1 and auc of (N,) binary labels against
    (N, 2) logits (the prediction is the argmax of their softmax)."""
    labels = np.asarray(labels).astype(np.int64)
    probs = softmax_np(logits)
    preds = probs.argmax(-1)
    tp = int(np.sum((preds == 1) & (labels == 1)))
    fp = int(np.sum((preds == 1) & (labels != 1)))
    fn = int(np.sum((preds != 1) & (labels == 1)))
    return {
        "accuracy": float(np.mean(preds == labels)),
        "precision": _ratio(tp, tp + fp),
        "recall": _ratio(tp, tp + fn),
        "f1": _ratio(2 * tp, 2 * tp + fp + fn),
        "auc": roc_auc(labels, probs[:, 1]),
    }


def metrics_row(metrics: Dict[str, float]) -> str:
    """Compact table row, in percent: F1 & AUC & acc & precision & recall."""
    keys = ("f1", "auc", "accuracy", "precision", "recall")
    return " & ".join(f"{metrics[k] * 100:.1f}" for k in keys)


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, n_classes: int = 2) -> np.ndarray:
    """(true, predicted) counts."""
    cm = np.zeros((n_classes, n_classes), np.int64)
    for t, p in zip(np.asarray(labels), np.asarray(preds)):
        cm[int(t), int(p)] += 1
    return cm


def save_confusion_matrix_figure(
    labels: np.ndarray,
    preds: np.ndarray,
    path: str,
    class_names: Sequence[str] = ("sMCI", "pMCI"),
) -> Optional[str]:
    """The confusion-matrix image at ``path``; returns the path, or None when
    matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    cm = confusion_matrix(labels, preds, n_classes=len(class_names))
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(class_names)), class_names)
    ax.set_yticks(range(len(class_names)), class_names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path

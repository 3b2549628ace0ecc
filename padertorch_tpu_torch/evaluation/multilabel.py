"""Multi-label audio tagging metrics: mAP, mAUC, lwlrap, F1.

Counterpart of ``padertorch_tpu/evaluation/multilabel.py``, copied as it
is (numpy only): the metrics the audio-tagging recipe reports (reference
``contrib/examples/sound_recognition/audio_tagging/evaluate.py:177``, via
sklearn/pb-internal helpers there).
"""
import numpy as np

__all__ = ['average_precision', 'mean_average_precision', 'auc',
           'mean_auc', 'lwlrap', 'fscore']


def average_precision(scores, targets):
    """AP for one class: scores (N,), binary targets (N,).

    >>> round(average_precision([0.9, 0.8, 0.3], [1, 0, 1]), 3)
    0.833
    """
    scores = np.asarray(scores, float)
    targets = np.asarray(targets, int)
    order = np.argsort(-scores)
    t = targets[order]
    if t.sum() == 0:
        return np.nan
    cum_pos = np.cumsum(t)
    precision = cum_pos / np.arange(1, len(t) + 1)
    return float((precision * t).sum() / t.sum())


def mean_average_precision(scores, targets):
    """mAP over classes: scores/targets (N, C); nan classes skipped."""
    scores = np.asarray(scores)
    targets = np.asarray(targets)
    aps = [average_precision(scores[:, c], targets[:, c])
           for c in range(scores.shape[1])]
    return float(np.nanmean(aps))


def auc(scores, targets):
    """ROC-AUC for one class (Mann-Whitney U).

    >>> auc([0.9, 0.8, 0.3, 0.1], [1, 1, 0, 0])
    1.0
    """
    scores = np.asarray(scores, float)
    targets = np.asarray(targets, int)
    pos = scores[targets == 1]
    neg = scores[targets == 0]
    if len(pos) == 0 or len(neg) == 0:
        return np.nan
    greater = (pos[:, None] > neg[None, :]).sum()
    ties = (pos[:, None] == neg[None, :]).sum()
    return float((greater + 0.5 * ties) / (len(pos) * len(neg)))


def mean_auc(scores, targets):
    scores = np.asarray(scores)
    targets = np.asarray(targets)
    aucs = [auc(scores[:, c], targets[:, c])
            for c in range(scores.shape[1])]
    return float(np.nanmean(aucs))


def lwlrap(scores, targets):
    """Label-weighted label-ranking average precision (DCASE 2019).

    >>> s = np.array([[0.9, 0.1], [0.2, 0.8]])
    >>> t = np.array([[1, 0], [0, 1]])
    >>> lwlrap(s, t)
    1.0
    """
    scores = np.asarray(scores, float)
    targets = np.asarray(targets, int)
    n, c = scores.shape
    precisions = np.zeros_like(scores, dtype=float)
    for i in range(n):
        pos = np.flatnonzero(targets[i])
        if len(pos) == 0:
            continue
        rank = np.argsort(-scores[i])
        hit_rank = {label: r for r, label in enumerate(rank)}
        for label in pos:
            r = hit_rank[label]
            top = rank[:r + 1]
            precisions[i, label] = targets[i][top].sum() / (r + 1)
    label_weight = targets.sum(0) / max(targets.sum(), 1)
    per_label = np.array([
        precisions[targets[:, col] == 1, col].mean()
        if (targets[:, col] == 1).any() else 0.0
        for col in range(c)
    ])
    return float((per_label * label_weight).sum())


def fscore(scores, targets, threshold=0.5, beta=1.0):
    """Macro F-score at a decision threshold."""
    scores = np.asarray(scores)
    targets = np.asarray(targets, int)
    decisions = (scores >= threshold).astype(int)
    tp = ((decisions == 1) & (targets == 1)).sum(0)
    fp = ((decisions == 1) & (targets == 0)).sum(0)
    fn = ((decisions == 0) & (targets == 1)).sum(0)
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / np.maximum(tp + fn, 1)
    f = (1 + beta ** 2) * precision * recall / np.maximum(
        beta ** 2 * precision + recall, 1e-12)
    return float(f.mean())

"""Verification / identification metrics.

Behavioral port of the reference score layer (reference: utils/modules.py:18-88):
AUC, EER, TPR@FPR in {1e-5, 1e-4, 1e-3}, summed score, best-threshold accuracy,
and rank-1 identification accuracy over per-subject pair groups. Implemented in
pure numpy (ROC construction matches sklearn.metrics.roc_curve semantics, which
the reference uses) so the metric layer has no heavyweight dependency.

Copy of text_guided_face_recognition_tpu/utils/metrics.py: the port keeps
its own, so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "roc_curve",
    "auc",
    "roc_metrics",
    "get_tpr",
    "cal_accuracy",
    "calculate_scores",
    "calculate_identification_acc",
]


def roc_curve(y_true: np.ndarray, y_score: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC curve with sklearn.metrics.roc_curve semantics (drop_intermediate=False
    is NOT applied — like sklearn we drop collinear points is skipped here for
    exactness; thresholds descend, curve starts at (0, 0)).
    """
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)

    desc = np.argsort(-y_score, kind="mergesort")
    y_score = y_score[desc]
    y_true = y_true[desc]

    # indices where score changes (threshold boundaries)
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs].astype(np.float64)
    fps = (1 + threshold_idxs) - tps

    # prepend (0, 0)
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, y_score[threshold_idxs]]

    p = tps[-1] if tps[-1] > 0 else 1.0
    n = fps[-1] if fps[-1] > 0 else 1.0
    return fps / n, tps / p, thresholds


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under a curve; tolerates descending x (abs value),
    matching sklearn.metrics.auc."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return float(abs(np.trapezoid(y, x)))


def get_tpr(fprs: np.ndarray, tprs: np.ndarray) -> List[float]:
    """TPR (%) at the FPR grid {1e-5, 1e-4, 1e-3} by nearest-FPR selection
    (reference: utils/modules.py:40-47 picks argmin |fpr - target|)."""
    fpr_val = [10**-5, 10**-4, 10**-3]
    out = []
    for target in fpr_val:
        idx = int(np.argmin(np.abs(fprs - target)))
        out.append(float(tprs[idx] * 100.0))
    return out


def cal_accuracy(y_score: Sequence[float], y_true: Sequence[int]) -> Tuple[float, float]:
    """Best-threshold verification accuracy scan (reference: utils/modules.py:18-32),
    vectorized (the reference is an O(N^2) python loop)."""
    y_score = np.asarray(y_score, dtype=np.float64)
    y_true = np.asarray(y_true)
    order = np.argsort(-y_score, kind="mergesort")
    s = y_score[order]
    t = y_true[order].astype(np.int64)
    n = len(s)
    # predictions >= threshold s[k] are the first k+1 entries (ties handled by
    # scanning every sample value as a threshold, like the reference)
    tp = np.cumsum(t)
    fp = np.arange(1, n + 1) - tp
    tn = (n - t.sum()) - fp
    acc = (tp + tn) / n
    k = int(np.argmax(acc))
    return float(acc[k]), float(s[k])


def roc_metrics(y_score: Sequence[float], y_true: Sequence[int]) -> Dict[str, float]:
    """All verification metrics in one dict (reference: utils/modules.py:52-65)."""
    fprs, tprs, _ = roc_curve(np.asarray(y_true), np.asarray(y_score))
    fprs = np.flipud(fprs)
    tprs = np.flipud(tprs)
    eer = float(fprs[np.nanargmin(np.absolute((1 - tprs) - fprs))])
    area = auc(fprs, tprs)
    tpr_fpr_row = get_tpr(fprs, tprs)
    total = sum(tpr_fpr_row)
    return {
        "auc": area,
        "eer": eer,
        "tpr@fpr=1e-5": tpr_fpr_row[0],
        "tpr@fpr=1e-4": tpr_fpr_row[1],
        "tpr@fpr=1e-3": tpr_fpr_row[2],
        "score": total,
    }


def calculate_scores(y_score, y_true, args=None, is_roc: Optional[bool] = None,
                     roc_file: Optional[str] = None) -> Dict[str, float]:
    """Print the reference's one-line score report and optionally dump the ROC
    arrays to .npy (reference: utils/modules.py:52-72 — identical format so
    downstream parity tooling can diff stdout)."""
    m = roc_metrics(y_score, y_true)
    print(
        "AUC {:.4f} | EER {:.4f} | TPR@FPR=1e-5 {:.4f} | TPR@FPR=1e-4 {:.4f} | "
        "TPR@FPR=1e-3 {:.4f} | score {:.4f}".format(
            m["auc"], m["eer"], m["tpr@fpr=1e-5"], m["tpr@fpr=1e-4"],
            m["tpr@fpr=1e-3"], m["score"]
        )
    )
    if is_roc is None and args is not None:
        is_roc = bool(getattr(args, "is_roc", False))
        roc_file = roc_file or getattr(args, "roc_file", "roc")
    if is_roc:
        filename = os.path.join(".", (roc_file or "roc") + ".npy")
        print("saving npy file in :", filename)
        with open(filename, "wb") as f:
            np.save(f, np.asarray(y_true))
            np.save(f, np.asarray(y_score))
    return m


def calculate_identification_acc(y_score, args=None, test_sub: Optional[int] = None,
                                 dump_path: Optional[str] = None) -> float:
    """Rank-1 identification accuracy over per-subject pair groups
    (reference: utils/modules.py:76-88): scores arrive grouped as
    [1 genuine + K imposter] pairs per subject; the genuine pair sits at column
    `subject_index` of its row (pair lists are built that way offline:
    data/face2text/scripts/test_list_identification.py:5-38)."""
    y_score = np.asarray(y_score, dtype=np.float64)
    if test_sub is None:
        test_sub = int(getattr(args, "test_sub"))
    if dump_path is None and args is not None:
        ckpt = getattr(args, "checkpoints_path", None)
        if ckpt:
            os.makedirs(ckpt, exist_ok=True)
            dump_path = os.path.join(ckpt, "ident_file")
    if dump_path:
        with open(dump_path, "wb") as f:
            np.save(f, y_score)

    pair_each_sub = len(y_score) // test_sub
    if pair_each_sub < 1:
        import warnings
        warnings.warn(f"identification: only {len(y_score)} scores for "
                      f"{test_sub} subjects; skipping rank-1 accuracy")
        return float("nan")
    print("total subjects: ", test_sub)
    grid = y_score[: test_sub * pair_each_sub].reshape((test_sub, pair_each_sub))
    pred = np.argmax(grid, axis=1)
    truth = np.arange(test_sub)
    acc = float(np.sum(pred == truth)) / test_sub
    print("identification accuracy (%)", acc * 100)
    return acc * 100

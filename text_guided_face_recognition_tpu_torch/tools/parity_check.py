"""Score-level parity harness.

  python -m text_guided_face_recognition_tpu_torch.tools.parity_check \
      reference_run.npy our_run.npy [--atol 1e-4]

Counterpart of tools/parity_check.py on the port's utils/metrics.
roc_metrics. Compares two verification runs through their ROC dumps (the
`is_roc` .npy files that the reference, the JAX package and the port write:
the pair labels, then the scores; reference utils/modules.py:67-72, the
port's utils/metrics.py `calculate_scores`): reports the per-pair score
differences and the metric-level differences (AUC, EER, TPR@FPR). Exits 0
when every pair's score is within --atol, 2 when one is not, 1 when the
dumps hold different pair lists.
"""

from __future__ import annotations

import argparse

import numpy as np

from text_guided_face_recognition_tpu_torch.utils.metrics import roc_metrics


def load_dump(path: str):
    with open(path, "rb") as f:
        y_true = np.load(f)
        y_score = np.load(f)
    return np.asarray(y_true), np.asarray(y_score)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ref")
    ap.add_argument("ours")
    ap.add_argument("--atol", type=float, default=1e-4,
                    help="per-pair score tolerance")
    args = ap.parse_args(argv)

    yt_a, ys_a = load_dump(args.ref)
    yt_b, ys_b = load_dump(args.ours)

    if yt_a.shape != yt_b.shape:
        print(f"FAIL: pair-count mismatch {yt_a.shape} vs {yt_b.shape}")
        raise SystemExit(1)
    if not np.array_equal(yt_a, yt_b):
        print("FAIL: pair labels differ — runs used different pair lists")
        raise SystemExit(1)

    d = np.abs(ys_a - ys_b)
    print(f"pairs: {len(ys_a)} | score delta max {d.max():.3e} "
          f"mean {d.mean():.3e} p99 {np.percentile(d, 99):.3e}")

    ma = roc_metrics(ys_a, yt_a)
    mb = roc_metrics(ys_b, yt_b)
    worst = 0.0
    for k in ma:
        delta = abs(ma[k] - mb[k])
        worst = max(worst, delta if k in ("auc", "eer") else 0.0)
        print(f"{k:>14}: ref {ma[k]:.6f} | ours {mb[k]:.6f} | d {delta:.2e}")

    ok = d.max() <= args.atol
    print("PARITY:", "PASS" if ok else
          f"SCORE-DELTA>{args.atol} (AUC/EER delta {worst:.2e})")
    raise SystemExit(0 if ok else 2)


if __name__ == "__main__":
    main()

"""Paper metrics (§V-C): class-weighted Accuracy / Precision / Recall / F1 /
FPR, computed per class one-vs-rest and weighted by class support — plus the
fleet-health summary of a faulted run's round logs.
"""
from __future__ import annotations

import numpy as np


def weighted_metrics(y_true, y_pred, num_classes):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    n = len(y_true)
    support = np.bincount(y_true, minlength=num_classes).astype(np.float64)
    w = support / max(n, 1)

    # one-vs-rest counts of every class at once (a vocabulary-wide model
    # has 151,936 classes); the same float operations as class by class
    tp = np.bincount(y_true[y_pred == y_true],
                     minlength=num_classes)[:num_classes]
    fp = np.bincount(y_pred, minlength=num_classes)[:num_classes] - tp
    fn = np.bincount(y_true, minlength=num_classes)[:num_classes] - tp
    tn = n - tp - fp - fn
    prec = tp / np.maximum(tp + fp, 1)
    rec = tp / np.maximum(tp + fn, 1)
    f1 = 2 * tp / np.maximum(2 * tp + fn + fp, 1)
    fpr = fp / np.maximum(fp + tn, 1)

    return {
        "accuracy": float(np.mean(y_true == y_pred)),
        "precision": float(np.sum(w * prec)),
        "recall": float(np.sum(w * rec)),
        "f1": float(np.sum(w * f1)),
        "fpr": float(np.sum(w * fpr)),
    }


def fleet_health(logs):
    """Summarize a run's RoundLogs into the fault/degradation metrics the
    chaos suite and ``bench_fleet --faults`` report.

    ``mean_quorum_frac`` is the round-efficiency headline: delivered
    uploads over the participation target k, averaged over rounds — 1.0 on
    the happy path, degrading as crashes/losses/churn eat into quorums
    (``target_k`` is 0 on pre-fault logs; those rounds count as full).
    Every entry derives purely from the scheduler's fault trace, so it is
    bit-identical across engines replaying the same trace.
    """
    rounds = len(logs)
    fracs = [l.quorum / l.target_k for l in logs if l.target_k]
    return {
        "rounds": rounds,
        "degraded_rounds": sum(1 for l in logs if l.degraded),
        "deadline_hits": sum(1 for l in logs if l.deadline_hit),
        "mean_quorum_frac": float(np.mean(fracs)) if fracs else 1.0,
        "crashes": sum(l.crashes for l in logs),
        "lost_uploads": sum(len(l.lost) for l in logs),
        "quarantined": sum(len(l.corrupted) for l in logs),
        "departures": sum(len(l.departed) for l in logs),
        "rejoins": sum(len(l.rejoined) for l in logs),
        "resyncs": sum(len(l.resynced) for l in logs),
        "forced_restarts": sum(len(l.forced) for l in logs),
    }

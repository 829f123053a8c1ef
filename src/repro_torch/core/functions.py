"""The paper's weighting functions (§IV-D, §IV-E).

* dynamic supervised-learning weight f(r): alpha=1/2 -> beta=1/(C*M+1)
* staleness functions g(s): constant / polynomial / hinge / exponential
* round-weight functions h(r): constant / logarithmic / polynomial /
  exponential smoothing / exponential
* adaptive learning rate eta_i = lambda / (M * f_i) with round-weighted
  participation frequency (Eq. 11-12).
"""
from __future__ import annotations

import math

import numpy as np

E = math.e


# --- dynamic supervised weight f(r) (§IV-D1) -------------------------------
def supervised_weight(r, *, C, M, alpha=0.5, kappa=10.0, mode="adaptive"):
    """Monotone decay from alpha to beta = 1/(C*M+1).

    The paper fixes the endpoints and monotonicity but not the curve; we use
    exponential decay with time constant ``kappa`` rounds (recorded choice).
    ``mode``: adaptive | fixed_alpha | fixed_beta (for Table XI ablation).
    """
    beta = 1.0 / (C * M + 1.0)
    if mode == "fixed_alpha":
        return alpha
    if mode == "fixed_beta":
        return beta
    return beta + (alpha - beta) * math.exp(-r / kappa)


# --- staleness functions g(s) (§V-D1) ---------------------------------------
def staleness_fn(name, a=None, b=0):
    name = name.lower()
    if name == "constant":
        return lambda s: 1.0
    if name == "polynomial":
        aa = 0.5 if a is None else a
        return lambda s: float((s + 1.0) ** (-aa))
    if name == "hinge":
        # FedAsync-style hinge: flat at 1 until s = b, then the polynomial
        # decay RESTARTS at the hinge point — 1 / (a * (s - b) + 1), which
        # is continuous at s = b for any b (the former s + b form jumped
        # from 1 to 1/(2ab+1) there whenever b > 0)
        aa = 1.0 if a is None else a
        return lambda s: 1.0 if s <= b else 1.0 / (aa * (s - b) + 1.0)
    if name == "exponential":
        aa = E / 2 if a is None else a
        return lambda s: float(aa ** (-s))
    raise ValueError(name)


# --- round-weight functions h(r) (§V-D2) ------------------------------------
def round_weight_fn(name, a=None):
    name = name.lower()
    if name == "constant":
        return lambda r: 1.0
    if name == "logarithmic":
        return lambda r: math.log1p(r)
    if name == "polynomial":
        aa = 0.5 if a is None else a
        return lambda r: (1.0 + r) ** aa
    if name == "exponential_smoothing":
        aa = 0.1 if a is None else a
        return lambda r: (1.0 + aa) ** r
    if name == "exponential":
        aa = E / 2 if a is None else a
        return lambda r: aa ** r
    raise ValueError(name)


# --- adaptive learning rate (Eq. 11-12) --------------------------------------
def adaptive_learning_rates(participation, *, base_lr, round_weight="constant",
                            clip=(0.2, 5.0), adaptive=True):
    """participation: (R_so_far, M) 0/1 matrix of global-update participation.

    f_i = sum_r h(r) * part[r, i] / sum_j sum_r h(r) * part[r, j]
    eta_i = lambda / (M * f_i), clipped to clip * lambda.
    """
    participation = np.asarray(participation, dtype=np.float64)
    M = participation.shape[1]
    if not adaptive or participation.size == 0:
        return np.full(M, base_lr)
    h = round_weight_fn(round_weight)
    w = np.array([h(r) for r in range(participation.shape[0])])
    scores = (w[:, None] * participation).sum(axis=0)
    total = scores.sum()
    if total <= 0:
        return np.full(M, base_lr)
    f = scores / total
    with np.errstate(divide="ignore"):
        eta = np.where(f > 0, base_lr / (M * np.maximum(f, 1e-12)),
                       base_lr * clip[1])
    return np.clip(eta, base_lr * clip[0], base_lr * clip[1])

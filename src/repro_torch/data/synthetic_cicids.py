"""Synthetic CIC-IDS-2017-like dataset: the port's numpy copy of
``repro/data/synthetic_cicids.py``, with the fleet-scale generator and its
pooled shards. The real dataset is not available offline.

78 continuous features, 9 classes (Benign + 8 attacks), class-conditional
two-component Gaussian mixtures with enough separation that >98% accuracy is
achievable — matching the paper's operating regime (its CNN reaches 98%+).

Per-client sample counts reproduce Table III exactly (scaled by ``scale``),
for both the basic (non-IID) and balanced (IID) scenarios; Shannon entropies
therefore match the table too. The server holds a stratified labeled split
(~5% of training data by default, §V-D5).
"""
from __future__ import annotations

import numpy as np

CLASS_NAMES = [
    "Benign", "DoS Hulk", "PortScan", "DDoS", "DoS GoldenEye",
    "FTP-Patator", "SSH-Patator", "DoS slowloris", "DoS Slowhttp",
]
NUM_CLASSES = len(CLASS_NAMES)
NUM_FEATURES = 78

# Table III — exact per-client class counts.
BASIC_SCENARIO = np.array([
    [4184, 37744, 19774, 12784, 1224, 884, 562, 524, 677],
    [64408, 16, 0, 0, 0, 1189, 1674, 1551, 1632],
    [10592, 19480, 34056, 1044, 992, 0, 0, 0, 0],
    [52248, 5883, 0, 0, 0, 0, 0, 0, 0],
    [256, 22000, 16072, 5456, 1016, 0, 0, 0, 0],
    [960, 18728, 8517, 10724, 264, 0, 0, 0, 0],
    [549, 19696, 9368, 0, 588, 0, 0, 478, 532],
    [24740, 0, 0, 0, 0, 0, 0, 0, 0],
    [1008, 8764, 0, 8764, 1788, 1855, 855, 0, 0],
    [776, 8064, 8064, 0, 0, 0, 0, 0, 0],
])

BALANCED_SCENARIO = np.array([
    [26848, 23744, 16465, 7308, 1322, 800, 665, 579, 625],
    [24146, 21354, 14808, 6573, 1189, 719, 598, 521, 562],
    [22670, 20049, 13903, 6171, 1116, 675, 562, 489, 528],
    [19918, 17615, 12215, 5422, 981, 593, 494, 430, 464],
    [15350, 13576, 9414, 4179, 756, 457, 380, 331, 357],
    [13429, 11877, 8236, 3656, 661, 400, 333, 290, 313],
    [10694, 9458, 6558, 2911, 527, 318, 265, 231, 249],
    [8477, 7497, 5199, 2308, 417, 252, 210, 183, 197],
    [7892, 6980, 4840, 2148, 389, 235, 196, 170, 184],
    [5792, 5122, 3552, 1577, 285, 172, 144, 125, 135],
])


def shannon_entropy(counts) -> float:
    """Paper Eq. 13: normalized Shannon entropy of a client's class counts.

    The paper normalizes by log K with K=10 (Table III's entropy column only
    reproduces with 10, not the 9 classes of the final dataset — presumably
    benign + 9 pre-filtering attack types).
    """
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts[counts > 0] / total
    if (counts > 0).sum() <= 1:
        return 0.0
    return float(-(p * np.log(p)).sum() / np.log(10))


class _ClassModel:
    """Two-component Gaussian mixture per class in feature space."""

    def __init__(self, rng: np.random.Generator, separation=4.0):
        # class means: unit directions scaled to ``separation`` sigma apart
        self.means = rng.normal(0, 1, (NUM_CLASSES, 2, NUM_FEATURES))
        self.means /= np.linalg.norm(self.means, axis=-1, keepdims=True)
        self.means *= separation
        # the two mixture components of one class sit near each other
        self.means[:, 1] = self.means[:, 0] + rng.normal(
            0, 0.15, (NUM_CLASSES, NUM_FEATURES))
        self.scales = rng.uniform(0.6, 1.4, (NUM_CLASSES, NUM_FEATURES))

    def sample(self, rng: np.random.Generator, cls: int, n: int):
        comp = rng.integers(0, 2, n)
        x = rng.normal(0, 1, (n, NUM_FEATURES)) * self.scales[cls]
        return (x + self.means[cls, comp]).astype(np.float32)


def make_dataset(scenario="basic", *, scale=0.02, server_frac=0.05,
                 test_frac=0.1, seed=0, separation=8.0):
    """Build the federated dataset.

    Returns dict with:
      clients: list of {"x": (n_i, 78)} unlabeled client data
               (+ hidden "y" for evaluation/oracle use only)
      server:  {"x", "y"} labeled server data (stratified, server_frac of train)
      test:    {"x", "y"}
      counts:  (M, 9) per-client class counts (scaled)
      entropy: (M,) per-client Shannon entropies
    """
    table = BASIC_SCENARIO if scenario == "basic" else BALANCED_SCENARIO
    rng = np.random.default_rng(seed)
    model = _ClassModel(rng, separation=separation)

    counts = np.maximum((table * scale).astype(int), 0)
    return _build_federation(counts, model, rng, server_frac, test_frac)


def make_fleet_dataset(num_clients, *, scenario="basic", scale=0.001,
                       jitter=0.3, server_frac=0.05, test_frac=0.1, seed=0,
                       separation=8.0, pool=None):
    """Fleet-scale federation (``synthetic_cicids.py:108-144``):
    ``num_clients`` clients whose class counts tile the Table III rows
    cyclically, each scaled by ``scale`` and a per-client uniform size
    jitter of +-``jitter``. Same return shape as ``make_dataset``. Keep
    ``scale`` small: the batched engine pads every client to the fleet's
    largest batch count.

    ``pool``: build only ``pool`` distinct client shards and alias them
    cyclically across the fleet (the clients share array references, no
    copies), so a million-client fleet takes the memory of a
    ``pool``-client one. The dict then carries ``"pool"``, from which the
    paged store keeps only the distinct rows. The server and test splits
    follow the pool's counts.
    """
    table = BASIC_SCENARIO if scenario == "basic" else BALANCED_SCENARIO
    rng = np.random.default_rng(seed)
    model = _ClassModel(rng, separation=separation)

    P = num_clients if pool is None else max(1, min(int(pool), num_clients))
    rows = table[np.arange(P) % len(table)]
    factors = rng.uniform(1.0 - jitter, 1.0 + jitter, (P, 1))
    counts = np.maximum((rows * scale * factors).astype(int), 0)
    # every client holds at least one sample of its majority class, so no
    # round sees an empty shard
    empty = counts.sum(axis=1) == 0
    counts[empty, np.argmax(rows[empty], axis=1)] = 1
    data = _build_federation(counts, model, rng, server_frac, test_frac)
    if pool is not None:
        reps = -(-num_clients // P)
        data["clients"] = (data["clients"] * reps)[:num_clients]
        data["counts"] = np.tile(counts, (reps, 1))[:num_clients]
        data["entropy"] = np.tile(data["entropy"], reps)[:num_clients]
        data["pool"] = P
    return data


def _build_federation(counts, model, rng, server_frac, test_frac):
    clients = []
    for i in range(counts.shape[0]):
        xs, ys = [], []
        for c in range(NUM_CLASSES):
            n = int(counts[i, c])
            if n == 0:
                continue
            xs.append(model.sample(rng, c, n))
            ys.append(np.full(n, c, np.int32))
        x = np.concatenate(xs) if xs else np.zeros((0, NUM_FEATURES), np.float32)
        y = np.concatenate(ys) if ys else np.zeros((0,), np.int32)
        perm = rng.permutation(len(x))
        clients.append({"x": x[perm], "y": y[perm]})

    total_train = int(counts.sum())
    overall = counts.sum(axis=0)

    def stratified(n_total):
        frac = overall / max(overall.sum(), 1)
        xs, ys = [], []
        for c in range(NUM_CLASSES):
            n = max(int(round(n_total * frac[c])), 2)
            xs.append(model.sample(rng, c, n))
            ys.append(np.full(n, c, np.int32))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        perm = rng.permutation(len(x))
        return {"x": x[perm], "y": y[perm]}

    server = stratified(max(int(total_train * server_frac), NUM_CLASSES * 2))
    test = stratified(max(int(total_train * test_frac), NUM_CLASSES * 10))
    entropy = np.array([shannon_entropy(c) for c in counts])
    return {
        "clients": clients,
        "server": server,
        "test": test,
        "counts": counts,
        "entropy": entropy,
    }

"""Synthetic token-sequence federation for the language-model-as-classifier
path (``core.model_adapter.LMAdapter``). Port of
``repro/data/synthetic_lm.py:57-113``, numpy only: the same arguments draw
the same arrays as the reference.

Clients hold unlabeled token sequences, the server a labeled split, and
a label is a class id from the vocabulary; the dict contract is
``data.synthetic_cicids.make_dataset``'s (``clients`` with the hidden
``"y"`` for evaluation only, ``server`` / ``test``, per-client ``counts``
and Shannon ``entropy``, optional ``pool`` aliasing for fleet-scale
runs). Token rows are float32 ``(n_i, seq_len)`` arrays (exact below
2**24), which ride the trainer's padded-data plumbing unchanged; the
adapter casts them to integers at the embedding.

Each class owns a few signature tokens that dominate its sequences;
client i majors in class ``i % C`` (the paper's Table III
heterogeneity).
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic_cicids import shannon_entropy

SIGNATURE_TOKENS = 8       # tokens owned by each class
SIGNATURE_FRAC = 0.7       # fraction of each sequence drawn from them


class _TokenClassModel:
    """Per-class token distributions over a shared vocabulary."""

    def __init__(self, rng, vocab_size, num_classes):
        if vocab_size < num_classes * (SIGNATURE_TOKENS + 1):
            raise ValueError(
                f"vocab_size={vocab_size} too small for {num_classes} "
                f"classes with {SIGNATURE_TOKENS} signature tokens each")
        self.vocab_size = vocab_size
        self.num_classes = num_classes
        # class ids double as label tokens; signature tokens live past them
        perm = num_classes + rng.permutation(vocab_size - num_classes)
        self.signatures = perm[:num_classes * SIGNATURE_TOKENS].reshape(
            num_classes, SIGNATURE_TOKENS)

    def sample(self, rng, cls, n, seq_len):
        sig = rng.choice(self.signatures[cls], size=(n, seq_len))
        noise = rng.integers(self.num_classes, self.vocab_size,
                             (n, seq_len))
        use_sig = rng.random((n, seq_len)) < SIGNATURE_FRAC
        return np.where(use_sig, sig, noise).astype(np.float32)


def make_lm_dataset(num_clients=8, *, vocab_size=512, seq_len=16,
                    num_classes=8, samples_per_client=48, jitter=0.3,
                    server_frac=0.25, test_samples=128, seed=0, pool=None):
    """Build the token-sequence federation (see module docstring).

    ``pool``: materialize only ``pool`` distinct client shards and alias
    them cyclically (array references, no copies) — same contract as
    ``make_fleet_dataset``.
    """
    rng = np.random.default_rng(seed)
    model = _TokenClassModel(rng, vocab_size, num_classes)

    P = num_clients if pool is None else max(1, min(int(pool), num_clients))
    # non-IID concentration: client i majors (~60%) in class i % C, the
    # rest spreads over two neighbour classes
    counts = np.zeros((P, num_classes), int)
    for i in range(P):
        n_i = max(int(samples_per_client
                      * rng.uniform(1.0 - jitter, 1.0 + jitter)), 4)
        major = i % num_classes
        counts[i, major] = int(n_i * 0.6)
        counts[i, (major + 1) % num_classes] = int(n_i * 0.25)
        counts[i, (major + 2) % num_classes] = \
            n_i - counts[i, major] - counts[i, (major + 1) % num_classes]

    def build_split(split_counts):
        xs, ys = [], []
        for c in range(num_classes):
            n = int(split_counts[c])
            if n == 0:
                continue
            xs.append(model.sample(rng, c, n, seq_len))
            ys.append(np.full(n, c, np.int32))
        x = np.concatenate(xs) if xs else \
            np.zeros((0, seq_len), np.float32)
        y = np.concatenate(ys) if ys else np.zeros((0,), np.int32)
        perm = rng.permutation(len(x))
        return {"x": x[perm], "y": y[perm]}

    clients = [build_split(counts[i]) for i in range(P)]
    total = int(counts.sum())
    even = np.full(num_classes,
                   max(int(total * server_frac) // num_classes, 2))
    server = build_split(even)
    test = build_split(np.full(num_classes,
                               max(test_samples // num_classes, 4)))
    entropy = np.array([shannon_entropy(c) for c in counts])

    data = {"clients": clients, "server": server, "test": test,
            "counts": counts, "entropy": entropy}
    if pool is not None:
        reps = -(-num_clients // P)
        data["clients"] = (data["clients"] * reps)[:num_clients]
        data["counts"] = np.tile(counts, (reps, 1))[:num_clients]
        data["entropy"] = np.tile(entropy, reps)[:num_clients]
        data["pool"] = P
    return data

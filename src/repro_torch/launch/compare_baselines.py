"""Paper Table XII in miniature on the port: FedS3A against FedAvg-SSL
(partial and all), FedAsync-SSL and the Local-SSL ceiling on the non-IID
basic scenario. Port of ``examples/compare_baselines.py``.

  PYTHONPATH=src python -m repro_torch.launch.compare_baselines
  PYTHONPATH=src python -m repro_torch.launch.compare_baselines --device cpu

``--device`` defaults to ``cuda`` (the card) and raises without one.
Environment knobs, as the reference example's: ``EXAMPLES_ROUNDS``
overrides the round count (8), ``EXAMPLES_SCALE`` the dataset scale
(0.008). The baselines train ``repro_torch.core.baselines.CNN_CONFIG``,
the paper CNN; FedS3A trains its config's ``cnn`` (the paper CNN by
default).
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.core import (FedAsyncSSL, FedAvgSSL, FedS3AConfig,
                              FedS3ATrainer, LocalSSL)
from repro_torch.data import make_dataset


def compare(device, rounds, scale):
    """The five rows ``[(name, train() result), ...]``."""
    data = make_dataset("basic", scale=scale, seed=0)
    cfg = FedS3AConfig(rounds=rounds, device=device)
    return [
        ("FedS3A", FedS3ATrainer(data, cfg).train()),
        ("FedAvg-SSL-Partial", FedAvgSSL(data, cfg, mode="partial").train()),
        ("FedAvg-SSL-All", FedAvgSSL(data, cfg, mode="all").train()),
        ("FedAsync-SSL", FedAsyncSSL(data, cfg).train(cfg.rounds * 4)),
        ("Local-SSL (ceiling)", LocalSSL(data, cfg).train())]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("--device is 'cuda' but CUDA is not available; "
                           "pass --device cpu to run on the CPU")
    rows = compare(args.device, int(os.environ.get("EXAMPLES_ROUNDS", "8")),
                   float(os.environ.get("EXAMPLES_SCALE", "0.008")))
    print(f"\n{'algorithm':22s} {'acc':>7s} {'f1':>7s} {'fpr':>7s} "
          f"{'ART(s)':>8s} {'ACO':>6s}")
    for name, res in rows:
        m = res["metrics"]
        print(f"{name:22s} {m['accuracy']:7.4f} {m['f1']:7.4f} "
              f"{m['fpr']:7.4f} {res['art']:8.1f} {res['aco']:6.2f}")
    return rows


if __name__ == "__main__":
    main()

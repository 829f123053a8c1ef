#!/usr/bin/env python3
"""How far the port's batched and sequential engines drift apart on one
CUDA card at the paper CNN's full width, with and without faults.

    python3 tools/engine_drift.py [--seeds 5] [--runs F1,F2] [--out FILE]
    python3 tools/engine_drift.py --runs G1,G2

For each seed, phase 5f's runs (``chip_smoke.FAULT_RUNS``; by default F1,
batched + csr, and F2, sequential + csr; ``chip_smoke.fault_config``: 7
rounds on phase 5's data, ``REFERENCE_CHURN`` with 5% corrupt uploads, a
700 s deadline, a quorum floor of 2) run once with the faults and once
without; each line prints every run's accuracy and ACO, the fault run's
fleet dict, and with two runs the largest metric difference and the ACO
difference between them. Phase 5g's dense-store runs
(``chip_smoke.DENSE_RUNS``, G1-G6: ``base_store="dense"``,
``chip_smoke.DENSE_ROUNDS`` rounds on phase 5's data) run fault-free only.
The two
engines sum in another order, so ties at the sampled threshold fall apart
round by round; this measures that spread, which ``chip_smoke.py`` phase
5f's F1-against-F2 and phase 5g's G1-against-G2 tolerances rest on.
"""
import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--runs", default="F1,F2")
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("engine_drift: CUDA is not available")
    import chip_smoke as cs
    from repro_torch.core import REFERENCE_CHURN
    from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    port = SimpleNamespace(FedS3AConfig=FedS3AConfig,
                           REFERENCE_CHURN=REFERENCE_CHURN)
    data = make_dataset("basic", scale=0.02)
    names = args.runs.split(",")
    dense = all(n in cs.DENSE_RUNS for n in names)

    def config(name, faulted, seed):
        if dense:
            engine, wire, ef, extra = cs.DENSE_RUNS[name]
            return FedS3AConfig(rounds=cs.DENSE_ROUNDS, engine=engine,
                                wire_format=wire, error_feedback=ef,
                                base_store="dense", seed=seed, **extra)
        return cs.fault_config(port, cs.FAULT_RUNS[name], faulted=faulted,
                               seed=seed)

    rows = []
    for seed in range(args.seeds):
        for faulted in ((False,) if dense else (True, False)):
            out = {}
            for name in names:
                tr = FedS3ATrainer(data, config(name, faulted, seed))
                out[name] = tr.train()
            row = {"seed": seed, "faulted": faulted,
                   "accuracy": {n: o["metrics"]["accuracy"]
                                for n, o in out.items()},
                   "aco": {n: o["aco"] for n, o in out.items()},
                   "fleet": next(iter(out.values()))["fleet"]
                   if faulted else None}
            if len(out) == 2:
                a, b = out.values()
                row["metric_diff"] = max(abs(a["metrics"][k] -
                                             b["metrics"][k])
                                         for k in a["metrics"])
                row["aco_diff"] = abs(a["aco"] - b["aco"])
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        Path(args.out).write_text(json.dumps(rows))


if __name__ == "__main__":
    main()

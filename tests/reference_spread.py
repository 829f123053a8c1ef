#!/usr/bin/env python3
"""How far engines drift apart under faults on the CPU at a reduced CNN:
the reference's batched engine against its own sequential one, and the
port's engines against the reference's sequential one. The numbers set
the tolerances of tests/test_torch_faults.py, tests/test_torch_fleet_ckpt.py
and ``chip_smoke.py`` phase 5f.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/reference_spread.py \\
        --cell chaos|test|5f [--wire csr|csr_q|dense_masked] [--ef] \\
        [--rounds R] [--no-faults] [--chunk] [--port batched,sequential] \\
        [--messages]

Cells: ``chaos`` is tests/test_chaos.py's acceptance run (50 rounds,
scale 0.0015, ``REFERENCE_CHURN``, EF, quorum floor 1); ``test`` the fault
tests' setting (8 rounds, scale 0.0015, 5% corrupt uploads, deadline 700
s, quorum floor 2); ``5f`` phase 5f's faults on phase 5's data (7 rounds,
scale 0.02). Every line prints the largest metric difference and the ACO
difference against the reference's sequential run. ``--messages`` prints,
round by round, the survivor count of every upload of the reference's and
the port's sequential runs, and how many elements of the port's first
upload sit exactly at its threshold (dense_masked). CPU only: like the
tests beside it, it imports both packages; it is a script, not a test
(pytest does not collect it), and times nothing.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(conv_filters=(8, 8), hidden=16, dropout=0.0)


def _cell(name, rounds):
    if name == "chaos":
        return dict(scale=0.0015, seed=0, rounds=rounds or 50,
                    cnn=dict(conv_filters=(8, 8), hidden=16), corrupt=0.0,
                    kw=dict(error_feedback=True, round_deadline=700.0,
                            quorum_floor=1))
    if name == "test":
        return dict(scale=0.0015, seed=0, rounds=rounds or 8, cnn=SMALL,
                    corrupt=0.05, kw=dict(round_deadline=700.0,
                                          quorum_floor=2))
    return dict(scale=0.02, seed=None, rounds=rounds or 7,
                cnn=dict(conv_filters=(8, 8), hidden=16), corrupt=0.05,
                kw=dict(round_deadline=700.0, quorum_floor=2))


def _diff(a, b):
    return (max(abs(a["metrics"][k] - b["metrics"][k]) for k in a["metrics"]),
            a["aco"] - b["aco"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("chaos", "test", "5f"),
                    default="test")
    ap.add_argument("--wire", default="csr")
    ap.add_argument("--ef", action="store_true")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--no-faults", action="store_true")
    ap.add_argument("--chunk", action="store_true",
                    help="chunk_size=700, conv and out kept at 0.5")
    ap.add_argument("--port", default="",
                    help="port engines to hold against the reference")
    ap.add_argument("--messages", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    from repro.configs.feds3a_cnn import CNNConfig as JCNN
    from repro.core import FedS3AConfig as JConfig
    from repro.core import FedS3ATrainer as JTrainer
    from repro.core import REFERENCE_CHURN as J_CHURN
    from repro.data import make_dataset as j_make_dataset
    from repro.models.cnn import init_cnn as j_init_cnn
    from repro_torch.configs.feds3a_cnn import CNNConfig
    from repro_torch.core import REFERENCE_CHURN
    from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer
    from repro_torch.data import make_dataset

    cell = _cell(args.cell, args.rounds)
    seed = {} if cell["seed"] is None else {"seed": cell["seed"]}
    kw = dict(wire_format=args.wire,
              error_feedback=args.ef or cell["kw"].get("error_feedback",
                                                       False))
    if args.chunk:
        kw.update(chunk_size=700, layer_keep_frac={"conv": 0.5, "out": 0.5})
    if not args.no_faults:
        kw.update(round_deadline=cell["kw"]["round_deadline"],
                  quorum_floor=cell["kw"]["quorum_floor"])
    traffic = {} if args.no_faults else {"traffic": dataclasses.replace(
        J_CHURN, corrupt_prob=cell["corrupt"])}
    p_traffic = {} if args.no_faults else {"traffic": dataclasses.replace(
        REFERENCE_CHURN, corrupt_prob=cell["corrupt"])}
    runs = {}
    for engine in ("sequential", "batched"):
        tr = JTrainer(j_make_dataset("basic", scale=cell["scale"], **seed),
                      JConfig(rounds=cell["rounds"], cnn=JCNN(**cell["cnn"]),
                              seed=0, engine=engine, **traffic, **kw))
        runs[engine] = (tr, tr.train())
    ref, want = runs["sequential"]
    m, a = _diff(runs["batched"][1], want)
    print(f"{args.cell} {args.wire} ef={kw['error_feedback']} faults="
          f"{not args.no_faults} rounds={cell['rounds']}: reference "
          f"batched - sequential: max |metric| {m:.3g}, ACO {a:.3g} "
          f"(sequential ACO {want['aco']:.6f}, fleet {want['fleet']})")
    _, k = jax.random.split(jax.random.PRNGKey(0))
    init = {n: np.asarray(v)
            for n, v in j_init_cnn(JCNN(**cell["cnn"]), k).items()}
    for engine in filter(None, args.port.split(",")):
        tr = FedS3ATrainer(
            make_dataset("basic", scale=cell["scale"], **seed),
            FedS3AConfig(rounds=cell["rounds"], cnn=CNNConfig(**cell["cnn"]),
                         seed=0, device="cpu", engine=engine, **p_traffic,
                         **kw), init_params=init)
        got = tr.train()
        m, a = _diff(got, want)
        print(f"  port {engine} - reference sequential: max |metric| "
              f"{m:.3g}, ACO {a:.3g}; fleet equal "
              f"{got['fleet'] == want['fleet']}")
    if args.messages:
        _messages(cell, seed, kw, traffic, p_traffic, init, JTrainer, JConfig, JCNN, j_make_dataset, FedS3ATrainer,
                  FedS3AConfig, CNNConfig, make_dataset)


def _messages(cell, seed, kw, traffic, p_traffic, init, JTrainer, JConfig, JCNN, j_make_dataset, FedS3ATrainer,
              FedS3AConfig, CNNConfig, make_dataset):
    """Survivor counts of every upload, round by round, on both packages'
    sequential engines (dense_masked), with the port's tie census."""
    from repro_torch.core import sparse_comm
    ref = JTrainer(j_make_dataset("basic", scale=cell["scale"], **seed),
                   JConfig(rounds=cell["rounds"], cnn=JCNN(**cell["cnn"]),
                           seed=0, engine="sequential", **traffic, **kw))
    port = FedS3ATrainer(
        make_dataset("basic", scale=cell["scale"], **seed),
        FedS3AConfig(rounds=cell["rounds"], cnn=CNNConfig(**cell["cnn"]),
                     seed=0, device="cpu", engine="sequential", **p_traffic,
                     **kw), init_params=init)
    seen_r, seen_p, first = [], [], {}
    deliver = ref.comm.deliver

    def ref_deliver(stats):
        seen_r.append(int(np.asarray(stats["nnz"])))
        return deliver(stats)

    account = port.comm._account

    def port_account(nnz, total, n):
        seen_p.append(int(nnz))
        return account(nnz, total, n)

    rows = sparse_comm.SparseComm._row_thresholds

    def tapped(self, delta, **kw_):
        thr = rows(self, delta, **kw_)
        if "census" not in first:
            a = delta.abs()[0]
            first["census"] = (int((a == thr[0]).sum()), a.numel())
        return thr

    ref.comm.deliver = ref_deliver
    port.comm._account = port_account
    sparse_comm.SparseComm._row_thresholds = tapped
    for r in range(cell["rounds"]):
        seen_r.clear()
        seen_p.clear()
        first.clear()
        ref.run_round()
        port.run_round()
        print(f"  round {r}: reference {seen_r}, port {seen_p}; port's "
              f"first upload: {first.get('census')} (elements at its "
              f"threshold, of)")
    sparse_comm.SparseComm._row_thresholds = rows


if __name__ == "__main__":
    main()

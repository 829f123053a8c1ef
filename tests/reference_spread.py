#!/usr/bin/env python3
"""How far engines drift apart under faults on the CPU at a reduced CNN:
the reference's batched engine against its own sequential one, and the
port's engines against the reference's sequential one. The numbers set
the tolerances of tests/test_torch_faults.py, tests/test_torch_fleet_ckpt.py
and ``chip_smoke.py`` phase 5f.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/reference_spread.py \\
        --cell chaos|test|5f|5 [--wire csr|csr_q|dense_masked] [--ef] \\
        [--rounds R] [--no-faults] [--chunk | --chunk-full] [--full] \\
        [--per-round] [--shares] [--port batched,sequential] [--messages]

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/reference_spread.py \\
        --cell lm [--wire ...] [--ef] [--q-dtype fp16] [--epochs E] \\
        [--disabled] [--threshold 1e-6] [--port batched,sequential]

Cells: ``lm`` is tests/test_torch_lm_trainer.py's setting (the reduced
qwen2 at ``lm-small``, V = 512, float32, 8 clients, 2 rounds, no faults;
the reference's initial LM); ``chaos`` is tests/test_chaos.py's acceptance run (50 rounds,
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
FULL = dict(dropout=0.0)      # the paper CNN's widths (configs/feds3a_cnn.py)
CHUNK_FULL = dict(chunk_size=1_000_000,
                  layer_keep_frac={"conv": 0.5, "out": 0.5})


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
    if name == "5":
        return dict(scale=0.02, seed=None, rounds=rounds or 3, cnn=SMALL,
                    corrupt=0.0,
                    kw={})
    return dict(scale=0.02, seed=None, rounds=rounds or 7,
                cnn=dict(conv_filters=(8, 8), hidden=16), corrupt=0.05,
                kw=dict(round_deadline=700.0, quorum_floor=2))


def _train(tr, rounds, per_round, what):
    """``tr.train(rounds)``, one round a call when ``per_round`` (the same
    run: ``train`` evaluates after its last round and changes nothing),
    printing the accuracy and ACO after each."""
    if not per_round:
        return tr.train(rounds)
    for r in range(rounds):
        out = tr.train(1)
        print(f"    {what} round {r}: accuracy "
              f"{out['metrics']['accuracy']:.6f}, ACO {out['aco']:.6f}, "
              f"participants {tr.logs[-1].participants}, rejoined "
              f"{tr.logs[-1].rejoined}, resynced {tr.logs[-1].resynced}",
              flush=True)
    return out


def _tap_reference_chunks(seen):
    """Record every chunk encode of the reference's chunked bodies as
    (chunk start, rows, stored sum) through a host callback from inside
    its jits."""
    import jax
    import jax.numpy as jnp
    from repro.core.sparse_comm import SparseComm
    one = SparseComm._chunk_encode_one

    def tapped(self, delta_c, plan_c):
        pay, stored, dec = one(self, delta_c, plan_c)
        s, rows = plan_c["s"], delta_c.shape[0]
        jax.debug.callback(
            lambda st: seen.append((s, rows, int(np.asarray(st)))),
            jnp.sum(stored))
        return pay, stored, dec
    SparseComm._chunk_encode_one = tapped


def _reference_shares(seen, plan):
    """Per chunk of ``plan``: the stored share over the recorded uploads
    (rows > 1) and chain encodes (one row)."""
    out = {}
    for what, keep in (("upload", lambda r: r > 1), ("chain",
                                                      lambda r: r == 1)):
        got = []
        for p in plan:
            hits = [(r, st) for s, r, st in seen if s == p["s"] and keep(r)]
            rows = sum(r for r, _ in hits)
            got.append(sum(st for _, st in hits) / max(rows * p["nc"], 1))
        out[what] = got
    return out


def _diff(a, b):
    return (max(abs(a["metrics"][k] - b["metrics"][k]) for k in a["metrics"]),
            a["aco"] - b["aco"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("chaos", "test", "5f", "5", "lm"),
                    default="test")
    ap.add_argument("--wire", default="csr")
    ap.add_argument("--ef", action="store_true")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--no-faults", action="store_true")
    ap.add_argument("--chunk", action="store_true",
                    help="chunk_size=700, conv and out kept at 0.5")
    ap.add_argument("--chunk-full", action="store_true",
                    help="chunk_size=1_000_000, conv and out kept at 0.5")
    ap.add_argument("--full", action="store_true",
                    help="the paper CNN at full width, dropout 0")
    ap.add_argument("--per-round", action="store_true")
    ap.add_argument("--shares", action="store_true")
    ap.add_argument("--port", default="",
                    help="port engines to hold against the reference")
    ap.add_argument("--messages", action="store_true")
    ap.add_argument("--q-dtype", default="int8", help="lm: csr_q values")
    ap.add_argument("--epochs", type=int, default=1, help="lm: epochs")
    ap.add_argument("--disabled", action="store_true",
                    help="lm: sparse_comm=False")
    ap.add_argument("--threshold", default="p0.2",
                    help="lm: the sparse threshold ('p0.2' or a float)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    if args.cell == "lm":
        return _lm_spread(args)
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
    if args.full:
        cell["cnn"] = FULL
    seed = {} if cell["seed"] is None else {"seed": cell["seed"]}
    kw = dict(wire_format=args.wire,
              error_feedback=args.ef or cell["kw"].get("error_feedback",
                                                       False))
    if args.chunk:
        kw.update(chunk_size=700, layer_keep_frac={"conv": 0.5, "out": 0.5})
    if args.chunk_full:
        kw.update(CHUNK_FULL)
    faults = not args.no_faults and args.cell != "5"
    if faults:
        kw.update(round_deadline=cell["kw"]["round_deadline"],
                  quorum_floor=cell["kw"]["quorum_floor"])
    traffic = {} if not faults else {"traffic": dataclasses.replace(
        J_CHURN, corrupt_prob=cell["corrupt"])}
    p_traffic = {} if not faults else {"traffic": dataclasses.replace(
        REFERENCE_CHURN, corrupt_prob=cell["corrupt"])}
    seen = []
    if args.shares:
        _tap_reference_chunks(seen)
    runs = {}
    for engine in ("sequential", "batched"):
        tr = JTrainer(j_make_dataset("basic", scale=cell["scale"], **seed),
                      JConfig(rounds=cell["rounds"], cnn=JCNN(**cell["cnn"]),
                              seed=0, engine=engine, **traffic, **kw))
        seen.clear()
        runs[engine] = (tr, _train(tr, cell["rounds"], args.per_round,
                                   f"reference {engine}"))
        if args.shares and tr.chunked:
            plan = tr.comm.chunk_plan()
            for what, got in _reference_shares(seen, plan).items():
                print(f"  reference {engine} {what} stored share by chunk "
                      f"(width): " + ", ".join(
                          f"{g:.6f} ({p['nc']})" for g, p in zip(got, plan)))
    ref, want = runs["sequential"]
    m, a = _diff(runs["batched"][1], want)
    print(f"{args.cell} {args.wire} ef={kw['error_feedback']} faults="
          f"{faults} full={args.full} rounds={cell['rounds']}: reference "
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
        got = _train(tr, cell["rounds"], args.per_round, f"port {engine}")
        m, a = _diff(got, want)
        print(f"  port {engine} - reference sequential: max |metric| "
              f"{m:.3g}, ACO {a:.3g} (port ACO {got['aco']:.6f}); fleet "
              f"equal {got['fleet'] == want['fleet']}")
        if args.shares and tr.chunked:
            plan = tr.comm.chunk_plan()
            for what, got in tr.comm.chunk_stored_share().items():
                print(f"  port {engine} {what} stored share by chunk "
                      f"(width): " + ", ".join(
                          f"{g:.6f} ({p['nc']})" for g, p in zip(got, plan)))
    if args.messages:
        _messages(cell, seed, kw, traffic, p_traffic, init, JTrainer, JConfig, JCNN, j_make_dataset, FedS3ATrainer,
                  FedS3AConfig, CNNConfig, make_dataset)


def _lm_spread(args):
    """The ``lm`` cell: the reference's batched engine against its own
    sequential one, then each ``--port`` engine against the reference's
    sequential run, from the reference's initial LM: metrics, ACO and the
    largest parameter difference. Model, data and run are the test's own
    constants."""
    sys.path.insert(0, str(ROOT / "tests"))
    import jax
    from test_torch_lm_trainer import DATA as LM_DATA
    from test_torch_lm_trainer import LM_SMALL
    from test_torch_lm_trainer import RUN as LM_RUN
    from repro.configs import get_config as jget_config
    from repro.configs import load_all as jload_all
    from repro.core import FedS3AConfig as JConfig
    from repro.core import FedS3ATrainer as JTrainer
    from repro.data.synthetic_lm import make_lm_dataset as j_make_lm
    from repro.models import lm as jlm
    from repro_torch.configs import get_config, load_all
    from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer
    from repro_torch.data import make_lm_dataset
    from repro_torch.tree import leaves
    from repro_torch.weights import params_to_numpy
    jload_all()
    load_all()
    thr = args.threshold if args.threshold.startswith("p") else \
        float(args.threshold)
    kw = dict(LM_RUN, wire_format=args.wire, error_feedback=args.ef,
              q_dtype=args.q_dtype, epochs=args.epochs,
              sparse_comm=not args.disabled, sparse_threshold=thr)
    jcfg = jget_config("qwen2-1.5b").reduced(**LM_SMALL)
    runs = {}
    for engine in ("sequential", "batched"):
        tr = JTrainer(j_make_lm(8, **LM_DATA),
                      JConfig(model=jcfg, engine=engine, use_kernels=False,
                              **kw))
        runs[engine] = (tr, tr.train())
    ref, want = runs["sequential"]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref.global_params)]

    def params_diff(got_leaves):
        return max(float(np.max(np.abs(a - b)))
                   for a, b in zip(got_leaves, ref_leaves))

    m, a = _diff(runs["batched"][1], want)
    p = params_diff([np.asarray(x) for x in
                     jax.tree.leaves(runs["batched"][0].global_params)])
    print(f"lm {args.wire} q_dtype={args.q_dtype} ef={args.ef} epochs="
          f"{args.epochs} disabled={args.disabled} threshold={thr}: "
          f"reference batched - sequential: max |metric| {m:.3g}, ACO "
          f"{a:.3g}, parameters {p:.3g} (sequential ACO {want['aco']:.6f})")
    _, k = jax.random.split(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jlm.init_params(jcfg, k))
    cfg = get_config("qwen2-1.5b").reduced(**LM_SMALL)
    for engine in filter(None, args.port.split(",")):
        tr = FedS3ATrainer(make_lm_dataset(8, **LM_DATA),
                           FedS3AConfig(model=cfg, device="cpu",
                                        engine=engine, **kw),
                           init_params=init)
        got = tr.train()
        m, a = _diff(got, want)
        p = params_diff(leaves(params_to_numpy(tr.global_params)))
        print(f"  port {engine} - reference sequential: max |metric| "
              f"{m:.3g}, ACO {a:.3g}, parameters {p:.3g} (port ACO "
              f"{got['aco']:.6f})")


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

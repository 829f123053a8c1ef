#!/usr/bin/env python3
"""A/B of the port's ``masked_pseudo_ce`` and ``csr_compact`` between two
trees on one CUDA card, interleaved parent / change / change / parent.

    python3 tools/kernel_ab.py --parent DIR [--out build/kernel_ab]

``DIR`` is a checkout of the parent commit (``git archive <commit> | tar
-x -C DIR``); the change is the tree this script lies in. Each run is one
process that imports ``repro_torch`` from its tree and measures it with
this tree's ``chip_smoke.py`` helpers, so both sides are timed alike:

- ``masked_pseudo_ce``, forward and backward through autograd as a client
  step runs them, at (600, 9) and (100, 9): device time and device ops a
  call (torch.profiler), host time a call, and the bound (logits and g
  read once; loss, mask and gradient written once);
- ``csr_compact`` at the batched upload (6, N), the sequential upload
  (1, N) and the EF residual (6, N): the same, plus CUDA-event time with
  the L2 flushed, the bound counting every slot of vals and idx;
- the six FL paths of ``chip_smoke.py`` phase 5: accuracy, ACO, seconds
  per round and launch counts.

It fails unless the change gives the parent's bits: loss, mask and
gradient of ``masked_pseudo_ce`` at (600, 9), (100, 9), (4096, 9) and
(300, 40) with tie and at-threshold rows, and every path's accuracy and
ACO; and unless the launch counts keep their meaning. It writes
``<out>.json`` and prints a summary.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MPCE_SHAPES = ((600, 9), (100, 9), (4096, 9), (300, 40))


def run_tree(tree, out):
    """Measure one tree; write ``out`` (JSON) and ``out`` .pt (the
    masked_pseudo_ce outputs)."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.core import sparse_comm as comm_mod
    from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build, ops, ref
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.zeros(96 * 2**20 // 4, dtype=torch.int32, device=dev)

    def flush():
        torch.bitwise_not(scratch, out=scratch)

    outputs, mpce = {}, []
    for n, c in MPCE_SHAPES:
        logits = cs._mpce_logits(torch, gen, dev, n, c)
        g = torch.rand((n,), generator=gen, device=dev)
        loss, mask, grad = cs._mpce_call(torch, ops.masked_pseudo_ce, None,
                                         logits, g)
        outputs[f"{n}x{c}"] = [t.detach().cpu() for t in (loss, mask, grad)]
        if (n, c) in MPCE_SHAPES[:2]:
            b, by = cs.bound_ms(8 * n * c + 12 * n, 11 * n * c + 7 * n)
            mpce.append({"shape": [n, c], **cs.profile_call(
                torch, lambda: cs._mpce_call(torch, ops.masked_pseudo_ce,
                                             None, logits, g), reps=200),
                "bound_ms": b, "bound_by": by})
    torch.save(outputs, Path(out).with_suffix(".pt"))

    x6 = cs._delta(torch, gen, dev, 6, cs.N_FULL)
    thr6 = comm_mod.local_quantile_thresholds(x6, 0.2)
    xres = x6 - ref.csr_capped_mask_ref(x6, thr6, cs.CAP_FULL)[0]
    csr = []
    for case, x, thr, cap in (
            ("batched upload", x6, thr6, cs.CAP_FULL),
            ("sequential upload", x6[:1].clone(), thr6[:1].clone(),
             cs.CAP_FULL),
            ("EF residual", xres,
             comm_mod.local_quantile_thresholds(xres, 0.25), cs.RCAP_FULL)):
        got = ops.csr_compact(x, thr, cap)
        want = ref.csr_compact2d_ref(x, thr, cap)
        cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"csr_compact {case} differs from its plain version")
        csr.append({"case": case, "shape": list(x.shape), "cap": cap,
                    **cs.csr_compact_call(torch, ops, ref, x, thr, cap,
                                          flush)})
    del x6, xres, scratch

    paths = {}
    for engine, wire, ef in cs.PATHS:
        cfg = FedS3AConfig(rounds=3, wire_format=wire, error_feedback=ef)
        if (engine, wire, ef) != cs.DEFAULT_PATH:
            cfg.engine = engine
        data = make_dataset("basic", scale=0.02)
        ops.reset_launches()
        tr = FedS3ATrainer(data, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tr.train()
        torch.cuda.synchronize()
        paths[cs.path_name(engine, wire, ef)] = {
            "s_per_round": (time.perf_counter() - t0) / 3,
            "accuracy": res["metrics"]["accuracy"], "aco": res["aco"],
            "launches": dict(ops.LAUNCHES)}
        del tr
    Path(out).write_text(json.dumps({
        "tree": str(tree), "masked_pseudo_ce": mpce, "csr_compact": csr,
        "paths": paths}))


def _same_outputs(torch, a, b):
    return {shape: all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(a[shape], b[shape])) for shape in a}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of the parent commit")
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_ab"))
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        return run_tree(args.tree, args.out)
    if not args.parent:
        ap.error("--parent is required")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for i, (label, tree) in enumerate((("parent", args.parent),
                                       ("change", ROOT), ("change", ROOT),
                                       ("parent", args.parent))):
        part = out.with_name(f"{out.name}_{i}_{label}.json")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, __file__, "--tree", str(tree),
                        "--out", str(part)], check=True)
        runs.append((label, part, json.loads(part.read_text())))
        print(f"  {label} ({time.perf_counter() - t0:.1f} s)", flush=True)
        r = runs[-1][2]
        for m in r["masked_pseudo_ce"]:
            print(f"    masked_pseudo_ce {m['shape']} forward + backward: "
                  f"device {m['device_ms']:.5f} ms in {m['device_ops']:g} "
                  f"ops, host {m['host_ms']:.5f} ms, bound "
                  f"{m['bound_ms']:.7f} ms", flush=True)
        for m in r["csr_compact"]:
            print(f"    csr_compact {m['case']} {m['shape']}: events "
                  f"{m['ms']:.5f} ms, device {m['device_ms']:.5f} ms in "
                  f"{m['device_ops']:g} ops, host {m['host_ms']:.5f} ms, "
                  f"bound {m['bound_ms']:.5f} ms", flush=True)
        for name, p in r["paths"].items():
            print(f"    {name}: {p['s_per_round']:.4f} s per round, accuracy "
                  f"{p['accuracy']:.6f}, ACO {p['aco']:.6f}, launches "
                  f"{p['launches']}", flush=True)

    import torch
    failures = []
    base = runs[0]
    for label, part, r in runs[1:]:
        same = _same_outputs(torch, torch.load(base[1].with_suffix(".pt")),
                             torch.load(part.with_suffix(".pt")))
        print(f"  {label} against the first parent run: masked_pseudo_ce "
              f"loss, mask and gradient bit-equal {same}", flush=True)
        if not all(same.values()):
            failures.append(f"{label}: masked_pseudo_ce outputs differ")
        for name, p in r["paths"].items():
            q = base[2]["paths"][name]
            if (p["accuracy"], p["aco"]) != (q["accuracy"], q["aco"]):
                failures.append(f"{label} {name}: accuracy / ACO "
                                f"{p['accuracy']} / {p['aco']}, parent "
                                f"{q['accuracy']} / {q['aco']}")
            lp, lq = p["launches"], q["launches"]
            for k in lq:
                if lp[k] != lq[k]:
                    failures.append(f"{label} {name}: {k} launched {lp[k]} "
                                    f"times, parent {lq[k]}")
            if label == "change" and \
                    lp["masked_pseudo_ce_bwd"] != lp["masked_pseudo_ce"]:
                failures.append(f"{name}: backward launches "
                                f"{lp['masked_pseudo_ce_bwd']}")

    def median(label, key, i, field):
        return statistics.median(r[key][i][field] for lb, _, r in runs
                                 if lb == label)
    summary = {"gpu": smi, "runs": [{"label": lb, "file": str(p)}
                                    for lb, p, _ in runs], "median": {}}
    for key in ("masked_pseudo_ce", "csr_compact"):
        for i, m in enumerate(runs[0][2][key]):
            what = f"{key} {m.get('case', '')} {m['shape']}".replace("  ", " ")
            row = {lb: {f: median(lb, key, i, f) for f in
                        ("device_ms", "device_ops", "host_ms")}
                   for lb in ("parent", "change")}
            row["bound_ms"] = m["bound_ms"]
            summary["median"][what] = row
            print(f"  median {what}: parent {row['parent']}, change "
                  f"{row['change']}, bound {m['bound_ms']:.7f} ms",
                  flush=True)
    summary["failures"] = failures
    out.with_suffix(".json").write_text(json.dumps(summary, indent=1))
    if failures:
        sys.exit("kernel_ab: " + "; ".join(failures))
    print("kernel_ab: the change gives the parent's bits on every check",
          flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""A/B of the port's FL kernels between two trees on one CUDA card,
interleaved parent / change / change / parent.

    python3 tools/kernel_ab.py --parent DIR [--out build/kernel_ab]

``DIR`` is a checkout of the parent commit (``git archive <commit> | tar
-x -C DIR``); the change is the tree this script lies in. Each run is one
process that imports ``repro_torch`` from its tree and measures it with
this tree's ``chip_smoke.py`` helpers, so both sides are timed alike (the
L2 flushed before each timed call by ``chip_smoke.l2_flushes``' clean
flush, which leaves no dirty line to write back):

- ``masked_pseudo_ce``, forward and backward through autograd as a client
  step runs them, at (600, 9) and (100, 9): device time and device ops a
  call (torch.profiler), host time a call, and the bound (logits and g
  read once; loss, mask and gradient written once);
- ``csr_compact`` at the batched upload (6, N), the sequential upload
  (1, N) and the EF residual (6, N): the same (``chip_smoke.
  memory_bound_call``: also the device time under the writing flush and
  CUDA-event times), the bound counting every slot of vals and idx;
- ``csr_quant`` at the batched upload (6, cap) and the sequential upload
  (1, cap), int8 and fp16, on ``csr_compact`` payloads: the same, the
  bound counting the stored prefix read and every output slot written;
- the vocabulary-wide ``masked_pseudo_ce`` kernels at the FL LM's (16,
  151936) and (96, 151936), forward alone and backward alone: the same
  as ``csr_compact``, the bound counting the logits read once and the
  outputs written once;
- the six FL paths of ``chip_smoke.py`` phase 5: accuracy, ACO, seconds
  per round and launch counts;
- phase 5h's L2 (qwen2-1.5b at full width, 2 layers, batched + csr, 3
  rounds): accuracy, ACO, rows the Eq. 5 mask kept each round, seconds
  per round and launches by (kernel, rows, width).

It fails unless the change gives the parent's bits: loss, mask and
gradient of ``masked_pseudo_ce`` at (600, 9), (100, 9), (4096, 9) and
(300, 40) with tie and at-threshold rows, and at every shape of
``chip_smoke.MPCE_WIDE_SHAPES`` (ties across the change's slice
boundaries planted; gradient through autograd and alone); q, offsets,
block counts and scales of ``csr_quant`` at both shapes in both types;
and every path's accuracy and ACO, and L2's rows kept; and unless the
launch counts keep their meaning (``csr_quant`` and ``csr_compact`` at
``chip_smoke.PER_ROUND``'s counts a round on both trees, L2's launches by
shape equal). It writes ``<out>.json`` and prints a summary.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

MPCE_SHAPES = ((600, 9), (100, 9), (4096, 9), (300, 40))


def _digest(t):
    """Type, shape and a SHA-256 of a tensor's bytes: equal digests mean
    equal bits."""
    import torch
    data = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    return f"{t.dtype} {tuple(t.shape)} {hashlib.sha256(data).hexdigest()}"


def wide_bounds():
    """The change's slices of each wide shape's row, {c: bounds}: both
    trees' wide logits plant their ties at the same columns."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    return {c: ops.wide_plan(c)["bounds"] for _, c in cs.MPCE_WIDE_SHAPES}


def run_tree(tree, out, bounds):
    """Measure one tree; write ``out`` (JSON, with digests of the outputs
    the trees must share)."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
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
    flushes = cs.l2_flushes(torch, dev)
    outputs, mpce = {}, []
    for n, c in MPCE_SHAPES:
        logits = cs._mpce_logits(torch, gen, dev, n, c)
        g = torch.rand((n,), generator=gen, device=dev)
        loss, mask, grad = cs._mpce_call(torch, ops.masked_pseudo_ce, None,
                                         logits, g)
        outputs[f"mpce {n}x{c}"] = [_digest(t) for t in (loss, mask, grad)]
        if (n, c) in MPCE_SHAPES[:2]:
            b, by = cs.bound_ms(8 * n * c + 12 * n, 11 * n * c + 7 * n)
            mpce.append({"shape": [n, c], **cs.profile_call(
                torch, lambda: cs._mpce_call(torch, ops.masked_pseudo_ce,
                                             None, logits, g), reps=200),
                "bound_ms": b, "bound_by": by})

    wide = []
    for n, c in cs.MPCE_WIDE_SHAPES:
        logits = cs._wide_logits(torch, bounds[str(c)], gen, dev, n, c)
        g = torch.rand((n,), generator=gen, device=dev)
        loss, mask, grad = cs._mpce_call(torch, ops.masked_pseudo_ce, None,
                                         logits, g)
        alone = ops.masked_pseudo_ce_grad(logits, mask, g)
        outputs[f"mpce {n}x{c}"] = [_digest(t)
                                    for t in (loss, mask, grad, alone)]
        if (n, c) in cs.MPCE_WIDE_TIMED:
            for what, fn, nbytes, nops in (
                    ("forward", lambda: ops.masked_pseudo_ce(logits,
                                                             cs.THETA),
                     4 * n * c + 8 * n, 4 * n * c),
                    ("backward", lambda: ops.masked_pseudo_ce_grad(
                        logits, mask, g), 8 * n * c + 8 * n, 7 * n * c)):
                wide.append({"case": what, "shape": [n, c],
                             **cs.memory_bound_call(torch, fn, nbytes, nops,
                                                    flushes)})
        del logits, g, loss, mask, grad, alone

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
                    **cs.csr_compact_call(torch, ops, x, thr, cap,
                                          flushes)})
    v6, i6, s6 = cs.quant_payload(torch, ops, comm_mod, x6, 0.2, cs.CAP_FULL)
    quant = []
    for case, v, i, s in (
            ("batched upload", v6, i6, s6),
            ("sequential upload", v6[:1].clone(), i6[:1].clone(),
             s6[:1].clone())):
        for q_dtype in ("int8", "fp16"):
            got = ops.csr_quantize(v, i, s, cs.N_FULL, q_dtype=q_dtype)
            outputs[f"csr_quant {case} {q_dtype}"] = [_digest(t)
                                                      for t in got]
            quant.append({"case": case, "shape": list(v.shape), **
                          cs.csr_quant_call(torch, ops, v, i, s, cs.N_FULL,
                                            q_dtype, flushes)})
    del x6, xres, v6, i6, s6, flushes

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
            "launches": dict(ops.LAUNCHES),
            "participants": [len(log.participants) for log in tr.logs]}
        del tr
    torch.cuda.empty_cache()
    port = cs.load_port()
    lm = cs.lm_run(torch, port, ops, "L2", cs.lm_config(
        port, cs.LM_LAYERS_CUT), "batched", "cuda", cs.LM_RUN["rounds"])
    paths["L2 (FL LM)"] = {
        **{k: lm.res[k] for k in ("s_per_round", "accuracy", "aco",
                                  "mask_kept", "launches_by_shape")},
        "launches": lm.res["launches"]}
    del lm
    Path(out).write_text(json.dumps({
        "tree": str(tree), "masked_pseudo_ce": mpce,
        "masked_pseudo_ce_wide": wide, "csr_compact": csr,
        "csr_quant": quant, "paths": paths, "outputs": outputs}))


def _same_outputs(a, b):
    """Per case: every output's type, shape and bits equal."""
    return {case: a[case] == b.get(case) for case in a}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of the parent commit")
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_ab"))
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--wide-bounds", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        return run_tree(args.tree, args.out, json.loads(args.wide_bounds))
    if not args.parent:
        ap.error("--parent is required")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    bounds = json.dumps(wide_bounds())
    runs = []
    for i, (label, tree) in enumerate((("parent", args.parent),
                                       ("change", ROOT), ("change", ROOT),
                                       ("parent", args.parent))):
        part = out.with_name(f"{out.name}_{i}_{label}.json")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, __file__, "--tree", str(tree),
                        "--out", str(part), "--wide-bounds", bounds],
                       check=True)
        runs.append((label, part, json.loads(part.read_text())))
        print(f"  {label} ({time.perf_counter() - t0:.1f} s)", flush=True)
        r = runs[-1][2]
        for m in r["masked_pseudo_ce"]:
            print(f"    masked_pseudo_ce {m['shape']} forward + backward: "
                  f"device {m['device_ms']:.5f} ms in {m['device_ops']:g} "
                  f"ops, host {m['host_ms']:.5f} ms, bound "
                  f"{m['bound_ms']:.7f} ms", flush=True)
        for key in ("masked_pseudo_ce_wide", "csr_compact", "csr_quant"):
            for m in r[key]:
                print(f"    {key} {m['case']} {m['shape']} "
                      f"{m.get('q_dtype', '')}: device "
                      f"{m['device_ms']:.5f} ms in {m['device_ops']:g} ops, "
                      f"host {m['host_ms']:.5f} ms, events "
                      f"{m['event_ms']:.5f} ms; under the writing flush "
                      f"device {m['device_ms_write_flush']:.5f} ms, events "
                      f"{m['event_ms_write_flush']:.5f} ms; bound "
                      f"{m['bound_ms']:.5f} ms", flush=True)
        for name, p in r["paths"].items():
            print(f"    {name}: {p['s_per_round']:.4f} s per round, accuracy "
                  f"{p['accuracy']:.6f}, ACO {p['aco']:.6f}, launches "
                  f"{p['launches']}", flush=True)
            if "mask_kept" in p:
                print(f"      rows kept a round {p['mask_kept']}, launches "
                      f"by shape {p['launches_by_shape']}", flush=True)

    failures = []
    base = runs[0]
    for label, part, r in runs[1:]:
        same = _same_outputs(base[2]["outputs"], r["outputs"])
        print(f"  {label} against the first parent run: outputs "
              f"bit-equal {same}", flush=True)
        failures += [f"{label}: {case} outputs differ"
                     for case, ok in same.items() if not ok]
        for name, p in r["paths"].items():
            q = base[2]["paths"][name]
            if (p["accuracy"], p["aco"]) != (q["accuracy"], q["aco"]):
                failures.append(f"{label} {name}: accuracy / ACO "
                                f"{p['accuracy']} / {p['aco']}, parent "
                                f"{q['accuracy']} / {q['aco']}")
            if p.get("mask_kept") != q.get("mask_kept") or \
                    p.get("launches_by_shape") != q.get("launches_by_shape"):
                failures.append(f"{label} {name}: rows kept "
                                f"{p.get('mask_kept')}, launches by shape "
                                f"{p.get('launches_by_shape')}; parent "
                                f"{q.get('mask_kept')}, "
                                f"{q.get('launches_by_shape')}")
            lp, lq = p["launches"], q["launches"]
            for k in lq:
                if lp[k] != lq[k]:
                    failures.append(f"{label} {name}: {k} launched {lp[k]} "
                                    f"times, parent {lq[k]}")
            if label == "change" and \
                    lp["masked_pseudo_ce_bwd"] != lp["masked_pseudo_ce"]:
                failures.append(f"{name}: backward launches "
                                f"{lp['masked_pseudo_ce_bwd']}")
    per_path = {cs.path_name(*k): v for k, v in cs.PER_ROUND.items()}
    for label, _, r in runs:
        for path, p in r["paths"].items():
            for kernel, per_round in per_path.get(path, {}).items():
                # a rule is a count a round or a function of the round's K
                want = sum(per_round(k) if callable(per_round) else per_round
                           for k in p["participants"])
                if p["launches"][kernel] != want:
                    failures.append(f"{label} {path}: {kernel} launched "
                                    f"{p['launches'][kernel]} times, not "
                                    f"{want} (K a round "
                                    f"{p['participants']})")

    def median(label, key, i, field):
        return statistics.median(r[key][i][field] for lb, _, r in runs
                                 if lb == label)
    summary = {"gpu": smi, "runs": [{"label": lb, "file": str(p)}
                                    for lb, p, _ in runs], "median": {}}
    for key in ("masked_pseudo_ce", "masked_pseudo_ce_wide", "csr_compact",
                "csr_quant"):
        for i, m in enumerate(runs[0][2][key]):
            what = f"{key} {m.get('case', '')} {m['shape']} " \
                f"{m.get('q_dtype', '')}".replace("  ", " ").strip()
            row = {lb: {f: median(lb, key, i, f) for f in
                        ("device_ms", "device_ops", "host_ms",
                         "device_ms_write_flush", "event_ms",
                         "event_ms_write_flush") if f in m}
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

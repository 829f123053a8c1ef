#!/usr/bin/env python3
"""Where an LM training step's time goes on one card, by torch.profiler.

    python3 tools/train_profile.py [--out FILE.json]

(a) The first training step of the reduced qwen2-1.5b in a fresh process
(``launch/train.py lm``'s model and step), then a second one: the host
operations that take the most time in each.
(b) qwen2-1.5b at full width and all 28 layers (bf16 compute, float32
parameters, ``impl="flash"``, remat), batch 8 x 2048 in 4 microbatches
as ``chip_smoke.py``'s T1: one warm-up step, then one microbatch's
forward and backward under the profiler (device busy share, the kernels
and host operations that take the most time), then ``adam_update`` alone,
each timed after a device synchronisation.

Prints the card's name and power limit first. Needs one CUDA card.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def log(msg):
    print(msg, flush=True)


def _profiled(torch, fn, top=12):
    """``fn()`` under torch.profiler: wall ms, device busy ms, kernel
    launches, and the heaviest kernels and host operations."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    ev = prof.key_averages()
    dev = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in ev if e.device_type == cuda
                  and e.self_device_time_total > 0), reverse=True)
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in ev if e.self_cpu_time_total > 0), reverse=True)
    busy = sum(r[0] for r in dev)
    out = {"wall_ms": wall, "busy_ms": busy,
           "launches": sum(r[1] for r in dev),
           "kernels": [{"ms": a, "count": b, "name": c[:100]}
                       for a, b, c in dev[:top]],
           "host_ops": [{"ms": a, "count": b, "name": c[:100]}
                        for a, b, c in host[:top]]}
    log(f"  wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}%), {out['launches']} kernel launches")
    for r in out["kernels"]:
        log(f"    device {r['ms']:10.3f} ms {r['count']:7d}x  {r['name']}")
    for r in out["host_ops"]:
        log(f"    host   {r['ms']:10.3f} ms {r['count']:7d}x  {r['name']}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_profile: CUDA is not available; this needs one GPU")
    from repro_torch.configs import get_config, load_all
    from repro_torch.models import lm
    from repro_torch.optimizer import adam_init, adam_update
    from repro_torch.training.steps import (lm_loss, make_train_step,
                                            value_and_grad)
    from repro_torch.tree import from_leaves
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    load_all()
    res = {"gpu": smi}
    dev = torch.device("cuda")

    cfg = get_config("qwen2-1.5b").reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen)
    opt = adam_init(params)
    step = make_train_step(cfg, lr=3e-4, impl="ref")
    for i in range(2):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 128),
                                         generator=gen, device=dev)}
        log(f"(a) reduced model, step {i} of a fresh process")

        def one():
            nonlocal params, opt
            params, opt, _ = step(params, opt, batch)
        res[f"reduced_step{i}"] = _profiled(torch, one)
    del params, opt

    cfg = get_config("qwen2-1.5b")
    B, S, mb = 8, 2048, 4
    params = lm.init_params(cfg, gen)
    opt = adam_init(params)
    step = make_train_step(cfg, lr=3e-4, num_microbatches=mb, impl="flash")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=dev)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, loss = step(params, opt, batch)
    torch.cuda.synchronize()
    res["full_step_s"] = time.perf_counter() - t0
    log(f"(b) full model, one step of {mb} microbatches: "
        f"{res['full_step_s']:.3f} s, loss {float(loss):.6f}")
    mbatch = {"tokens": batch["tokens"][:B // mb]}
    log("(b) one microbatch, forward and backward")
    grads = {}

    def fwd_bwd():
        grads["g"] = value_and_grad(
            lambda p: lm_loss(cfg, p, mbatch, impl="flash"), params)[1]
    res["full_microbatch"] = _profiled(torch, fwd_bwd)
    log("(b) adam_update")
    g = from_leaves(params, grads.pop("g"))
    res["full_adam"] = _profiled(
        torch, lambda: adam_update(g, opt, params, lr=3e-4))
    if args.out:
        Path(args.out).write_text(json.dumps(res))


if __name__ == "__main__":
    main()

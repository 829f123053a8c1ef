"""Training launcher. Port of ``repro/launch/train.py``.

Two modes:
  fl   — the paper: FedS3A over the synthetic CIC-IDS-2017 scenarios, with
         periodic checkpointing of the server state in the reference's
         msgpack layout (``fl_checkpoint_tree``).
  lm   — LM pretraining of a zoo architecture through
         ``training.steps.make_train_step`` (``--reduced``, the default and
         as in the reference the only value the flag can take, runs the
         reduced config with ``impl="ref"``; ``run_lm`` with
         ``reduced=False`` trains the full model with ``impl="flash"``).
         The tokens are drawn uniformly from a ``torch.Generator`` seeded
         by ``--seed`` (the reference draws them with ``jax.random``, so
         the token values and initial weights differ).

Both run on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train fl --scenario basic --rounds 10
  PYTHONPATH=src python -m repro_torch.launch.train lm --steps 5 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.launch.serve import _resolve_device, _sync


def fl_checkpoint_tree(tr):
    """The server state the reference's ``run_fl`` checkpoints, in the
    layout the reference's trainer of the same engine holds: the
    sequential engine's Adam state as a tree, the batched engine's as flat
    (N,) ``m`` and ``v`` with a scalar step count (the port's stacked
    engine keeps them as (1, N) and (1,))."""
    opt = tr.server_opt
    if tr.stacked:
        opt = {"m": opt["m"].reshape(-1), "v": opt["v"].reshape(-1),
               "t": opt["t"].reshape(())}
    return {"global_params": tr.global_params, "server_opt": opt,
            "participation": tr.participation, "round": tr.global_version}


def run_fl(args):
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core import FedS3AConfig, FedS3ATrainer
    from repro_torch.data import make_dataset

    data = make_dataset(args.scenario, scale=args.scale, seed=args.seed)
    cfg = FedS3AConfig(rounds=args.rounds, C=args.C, tau=args.tau,
                       seed=args.seed, device=args.device)
    tr = FedS3ATrainer(data, cfg)
    for r in range(args.rounds):
        log = tr.run_round()
        m = tr.evaluate()
        print(f"round {log.round:3d} art={log.art:6.1f}s acc={m['accuracy']:.4f} "
              f"f1={m['f1']:.4f} participants={log.participants}")
        if args.ckpt and (r + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, fl_checkpoint_tree(tr))
            print(f"  checkpoint -> {args.ckpt}")
    final = tr.evaluate()
    print(f"final acc={final['accuracy']:.4f} aco={tr.comm.aco:.2f}")
    return tr


def run_lm(args):
    """``args.steps`` training steps of ``args.arch``; returns ``{"cfg",
    "params", "opt", "losses", "seconds"}``, each step's seconds read
    after a device synchronisation."""
    from repro_torch.configs import get_config, load_all
    from repro_torch.models import lm
    from repro_torch.optimizer import adam_init
    from repro_torch.training.steps import make_train_step

    load_all()
    device = _resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen)
    opt = adam_init(params)
    step = make_train_step(cfg, lr=args.lr,
                           num_microbatches=args.microbatches,
                           impl="ref" if args.reduced else "flash")
    B, S = args.batch, args.seq
    losses, seconds = [], []
    for i in range(args.steps):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=gen, device=device)}
        _sync(device)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        loss = float(loss)
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"step {i}: loss={loss:.4f} ({seconds[-1]:.2f}s)")
    return {"cfg": cfg, "params": params, "opt": opt, "losses": losses,
            "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)

    fl = sub.add_parser("fl")
    fl.add_argument("--scenario", default="basic",
                    choices=["basic", "balanced"])
    fl.add_argument("--rounds", type=int, default=10)
    fl.add_argument("--scale", type=float, default=0.01)
    fl.add_argument("--C", type=float, default=0.6)
    fl.add_argument("--tau", type=int, default=2)
    fl.add_argument("--seed", type=int, default=0)
    fl.add_argument("--ckpt", default=None)
    fl.add_argument("--ckpt-every", type=int, default=5)
    fl.add_argument("--device", default="cuda")

    lm_ = sub.add_parser("lm")
    lm_.add_argument("--arch", default="qwen2-1.5b")
    lm_.add_argument("--steps", type=int, default=5)
    lm_.add_argument("--batch", type=int, default=2)
    lm_.add_argument("--seq", type=int, default=128)
    lm_.add_argument("--lr", type=float, default=3e-4)
    lm_.add_argument("--microbatches", type=int, default=1)
    lm_.add_argument("--reduced", action="store_true", default=True)
    lm_.add_argument("--seed", type=int, default=0)
    lm_.add_argument("--device", default="cuda")

    args = ap.parse_args(argv)
    return run_fl(args) if args.mode == "fl" else run_lm(args)


if __name__ == "__main__":
    main()

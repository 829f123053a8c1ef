"""Serving launcher: batched request loop over prefill + decode. Port of
``repro/launch/serve.py``.

Requests (prompt token lists) are left-padded into one bucket, prefilled
once, then decoded greedily against the KV cache. The prefill's attention
is the reference's plain attention by default (``impl="ref"``, as the
reference's ``serve_batch`` prefills), or the CUDA flash kernel on the
card (``impl="pallas"``; its plain version on the CPU).

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 6
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --attn-impl pallas
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.training.steps import make_prefill_step, make_serve_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def left_pad(prompts, bucket):
    """prompts: list[list[int]] -> (B, K) int64 tokens, each prompt
    left-padded with id 0 into ``K = min(bucket, longest prompt)``."""
    K = max(len(p) for p in prompts)
    K = min(bucket, max(K, 1))
    toks = np.zeros((len(prompts), K), np.int64)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p[:K]                # left-pad into the bucket
    return toks


def serve_batch(cfg, params, prompts, *, max_new, bucket, impl="ref",
                timings=None):
    """prompts: list[list[int]] -> (B, max_new) int32 continuations, on the
    device the parameters lie on. Pad tokens (id 0, on the left) are
    visible to the causal mask, as in the reference. The weights are cast
    to the compute dtype once per call. ``timings``, when a dict, gets the
    seconds of the cast (``cast_s``), of the prefill and first token
    (``prefill_s``) and of the ``max_new - 1`` decode steps (``decode_s``),
    each ended by a device synchronisation."""
    device = params["embed"].device
    toks = left_pad(prompts, bucket)
    B, K = toks.shape
    marks = [time.perf_counter()]

    def mark():
        if timings is not None:
            _sync(device)
            marks.append(time.perf_counter())

    with torch.inference_mode():
        wparams = lm.compute_params(cfg, params)
        mark()
        batch = {"tokens": torch.as_tensor(toks, device=device)}
        last, cache = make_prefill_step(cfg, K + max_new, impl=impl)(
            wparams, batch)
        serve = make_serve_step(cfg)
        tok = torch.argmax(last, dim=-1)
        out = [tok]
        mark()
        for i in range(max_new - 1):
            tok, _, cache = serve(wparams, cache, tok, K + i)
            out.append(tok)
        mark()
        result = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
    if timings is not None:
        timings.update(cast_s=marks[1] - marks[0],
                       prefill_s=marks[2] - marks[1],
                       decode_s=marks[3] - marks[2], decode_steps=max_new - 1,
                       batch=B, bucket=K)
    return result


def _resolve_device(name):
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device is 'cuda' but CUDA is not available; "
                           "pass --device cpu to run on the CPU")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--bucket", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", default="ref", choices=("ref", "pallas"))
    args = ap.parse_args(argv)

    device = _resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen)

    rngs = np.random.default_rng(args.seed)
    prompts = [list(rngs.integers(0, cfg.vocab_size,
                                  rngs.integers(4, args.bucket)))
               for _ in range(args.requests)]
    print(f"arch={args.arch} (reduced) on {device} — {len(prompts)} "
          f"requests, bucket={args.bucket}, max_new={args.max_new}, "
          f"attention {args.attn_impl}")
    t0 = time.time()
    outs = serve_batch(cfg, params, prompts, max_new=args.max_new,
                       bucket=args.bucket, impl=args.attn_impl)
    _sync(device)
    dt = time.time() - t0
    for i, o in enumerate(outs[:3]):
        print(f"  request {i} ({len(prompts[i])} prompt toks) -> {o.tolist()}")
    print(f"{args.requests * args.max_new} tokens in {dt:.2f}s "
          f"({args.requests * args.max_new / dt:.1f} tok/s)")
    return outs


if __name__ == "__main__":
    main()

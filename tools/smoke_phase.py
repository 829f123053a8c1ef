#!/usr/bin/env python3
"""One group of ``chip_smoke.py``'s phases alone, on one card. A quicker
loop than the whole script while working on one path; the whole script
stays the proof.

    python3 tools/smoke_phase.py lm [--out FILE.json]
    python3 tools/smoke_phase.py lmc [--out FILE.json]
    python3 tools/smoke_phase.py train [--out FILE.json]
    python3 tools/smoke_phase.py wide [--out FILE.json]
    python3 tools/smoke_phase.py lmo [--out FILE.json]

``lm``: the FL language-model checks: phase 3's vocabulary-wide
``masked_pseudo_ce`` kernels and the compaction kernels at the LM's flat
widths, then phase 5h (L2, L1, L0 against its CPU twin).
``lmc``: the chunked, faulted, checkpointed FL language model: phase 3's
vocabulary-wide ``masked_pseudo_ce`` kernels and the compaction kernels at
phase 5i's chunk widths, then phase 5i (LC, LCs, L0c against its CPU twin
and resumed, F2 the ``fl_large_model`` launcher).
``wide``: phase 3's vocabulary-wide ``masked_pseudo_ce`` kernels alone
(bit for bit at every shape, timed at the FL LM's), with nvcc's register
and spill report for their source.
``lmo``: the FL language model on the other wires and options: phase 3's
``masked_pseudo_ce`` kernels (narrow, J0's (16, 512) among them, and
vocabulary-wide), the compaction kernels at the LM's flat widths, the
bf16-logits case and phase 5j's widths
(``sparse_delta``, fp16 ``csr_quant``, J0's), then phase 5j (J1-J3 at 2
layers with their reckoned and measured peaks, J0 card against CPU).
``train``: phase 6b, LM training (T0 flash against ref and microbatches,
T0c card against CPU, T1 qwen2-1.5b at full width and depth, F1 the
``launch/train.py`` CLI), after phase 5's batched + csr path, whose run
F1 holds the CLI's ``fl`` checkpoint against.

Prints the card's name and power limit first, as ``chip_smoke.py`` does,
and fails where a phase fails; ``--out`` also writes the results as JSON.
Needs one CUDA card and nvcc.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_lm(torch, cs, port):
    from repro_torch.core import sparse_comm as comm_mod
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flushes = cs.l2_flushes(torch, dev)
    t0 = time.perf_counter()
    fwd, bwd = cs.check_masked_pseudo_ce_wide(torch, ops, ref, dev, gen,
                                              flushes)
    shapes, held = cs.check_lm_width_compaction(torch, ops, ref, comm_mod,
                                                port, dev, gen, flushes)
    del flushes
    torch.cuda.empty_cache()
    held |= {(k, n, c) for n, c in cs.MPCE_WIDE_SHAPES
             for k in ("masked_pseudo_ce", "masked_pseudo_ce_bwd")}
    cs.log(f"phase 3 (FL LM) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = cs.lm_path(torch, port, ops, held)
    cs.log(f"phase 5h took {time.perf_counter() - t0:.1f} s")
    return {"wide_forward": fwd, "wide_backward": bwd, "lm_widths": shapes,
            "lm_path": res}


def run_lmc(torch, cs, port):
    from repro_torch.core import sparse_comm as comm_mod
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    flushes = cs.l2_flushes(torch, dev)
    t0 = time.perf_counter()
    fwd, bwd = cs.check_masked_pseudo_ce_wide(
        torch, ops, ref, dev, torch.Generator(device=dev).manual_seed(0),
        flushes)
    shapes, held = cs.check_lm_chunk_widths(
        torch, ops, ref, comm_mod, port, dev,
        torch.Generator(device=dev).manual_seed(1), flushes,
        cs.lc_plans(port, comm_mod))
    del flushes
    torch.cuda.empty_cache()
    held |= {(k, n, c) for n, c in cs.MPCE_WIDE_SHAPES
             for k in ("masked_pseudo_ce", "masked_pseudo_ce_bwd")}
    cs.log(f"phase 3 (FL LM chunks) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = cs.lm_chunked(torch, port, ops, ref, comm_mod, held)
    cs.log(f"phase 5i took {time.perf_counter() - t0:.1f} s")
    return {"wide_forward": fwd, "wide_backward": bwd,
            "lm_chunk_widths": shapes, "lm_chunked": res}


def run_lmo(torch, cs, port):
    from repro_torch.core import sparse_comm as comm_mod
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flushes = cs.l2_flushes(torch, dev)
    t0 = time.perf_counter()
    fwd, bwd = cs.check_masked_pseudo_ce_wide(torch, ops, ref, dev, gen,
                                              flushes)
    shapes, held = cs.check_lm_width_compaction(torch, ops, ref, comm_mod,
                                                port, dev, gen, flushes)
    held |= {(k, n, c) for n, c in cs.MPCE_WIDE_SHAPES
             for k in ("masked_pseudo_ce", "masked_pseudo_ce_bwd")}
    cs.check_masked_pseudo_ce(torch, ops, ref, dev, gen)
    cs.check_masked_pseudo_ce_bf16(torch, ops, ref, dev, gen)
    lmo_shapes, lmo_held = cs.check_lm_option_widths(
        torch, ops, ref, comm_mod, port, dev,
        torch.Generator(device=dev).manual_seed(2), flushes)
    del flushes
    torch.cuda.empty_cache()
    cs.log(f"phase 3 (FL LM options) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = cs.lm_options(torch, port, ops, comm_mod, held | lmo_held)
    cs.log(f"phase 5j took {time.perf_counter() - t0:.1f} s")
    return {"wide_forward": fwd, "wide_backward": bwd, "lm_widths": shapes,
            "lm_option_widths": lmo_shapes, "lm_options": res}


def run_wide(torch, cs):
    from repro_torch.kernels import build, ops, ref
    for line in build.build_log.get("masked_pseudo_ce", "").splitlines():
        cs.log(f"  [masked_pseudo_ce] {line}")
    dev = torch.device("cuda")
    flushes = cs.l2_flushes(torch, dev)
    fwd, bwd = cs.check_masked_pseudo_ce_wide(
        torch, ops, ref, dev, torch.Generator(device=dev).manual_seed(0),
        flushes)
    return {"wide_forward": fwd, "wide_backward": bwd}


def run_train(torch, cs, port, smi):
    import numpy as np
    from repro_torch.kernels import ops
    _, _, batched_csr = cs.drive_path(torch, port, ops, *cs.DEFAULT_PATH)
    return {"lm_train": cs.lm_train(torch, np, port, smi, batched_csr)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=("lm", "lmc", "lmo", "train", "wide"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("smoke_phase: CUDA is not available; this needs one GPU")
    import chip_smoke as cs
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    port = cs.load_port()
    if args.phase == "lm":
        res = run_lm(torch, cs, port)
    elif args.phase == "lmc":
        res = run_lmc(torch, cs, port)
    elif args.phase == "lmo":
        res = run_lmo(torch, cs, port)
    elif args.phase == "wide":
        res = run_wide(torch, cs)
    else:
        res = run_train(torch, cs, port, smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(res, gpu=smi),
                                             default=str))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""``chip_smoke.py``'s FL language-model checks alone, on one card: phase
3's vocabulary-wide ``masked_pseudo_ce`` kernels and the compaction
kernels at the LM's flat widths, then phase 5h (L2, L1, L0 against its CPU
twin). A quicker loop than the whole script while working on the LM path;
the whole script stays the proof.

    python3 tools/lm_phase.py [--out FILE.json]

Prints the card's name and power limit first, as ``chip_smoke.py`` does,
and fails where the phases fail; ``--out`` also writes the phases'
results as JSON. Needs one CUDA card and nvcc.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("lm_phase: CUDA is not available; this needs one GPU")
    import chip_smoke as cs
    from repro_torch.configs import get_config, load_all
    from repro_torch.core import sparse_comm as comm_mod
    from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer
    from repro_torch.core.sparse_comm import flatten_tree
    from repro_torch.data import make_lm_dataset
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import lm
    from repro_torch.tree import leaves as tree_leaves
    from repro_torch.weights import params_to_numpy, tree_to_numpy
    load_all()
    port = SimpleNamespace(
        get_config=get_config, FedS3AConfig=FedS3AConfig,
        FedS3ATrainer=FedS3ATrainer, make_lm_dataset=make_lm_dataset,
        tree_leaves=tree_leaves, flatten_tree=flatten_tree, lm=lm,
        params_to_numpy=params_to_numpy, tree_to_numpy=tree_to_numpy)
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
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
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"wide_forward": fwd, "wide_backward": bwd, "lm_widths": shapes,
             "lm_path": res}, default=str))


if __name__ == "__main__":
    main()

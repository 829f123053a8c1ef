#!/usr/bin/env python3
"""Where the time of the vocabulary-wide ``masked_pseudo_ce`` kernels goes,
block by block, on one CUDA card.

    python3 tools/wide_timeline.py [--cluster S]
        [--shapes 16x151936,96x151936] [--out FILE.json]

Builds a copy of ``csrc/masked_pseudo_ce.cu`` under
``build/wide_timeline/`` in which thread 0 of every block stamps
``clock64`` and ``%globaltimer`` at each phase (start, copies issued, max
pass done, pairs exchanged, exp pass done, partials exchanged, end) and
records its SM id, with ``kCluster`` replaced by ``--cluster`` where
given (the slices then follow ``ops.wide_plan(c, S)``). For each shape
and direction it checks the copy bit for bit against the plain version,
then prints the profiler device time a call (the L2 flushed before each, as in ``chip_smoke.py`` phase 3), how
many blocks each SM held, the spread of the blocks' start and end times,
and each phase's median and largest time over the blocks (clock64 cycles
at the clock the block's own two timers give). The stamps cost a few
stores a block; compare variants within one call.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402

PHASES = ("copies issued", "max pass", "pairs exchanged", "exp pass",
          "partials exchanged", "end")
# the source line each stamp k >= 1 goes before (stamp 0 starts the kernel)
ANCHORS = ("  // the slice's (max, argmax)",
           "  for (int q = 1; q < 4; ++q) arg_join",
           "  float m = __int_as_float(pair[0].x);",
           "  double s = (p[0] + p[1])",
           "  double total = part[0];")
STAMP = r"""__device__ unsigned long long* g_stamps;
// clock64 at k, %globaltimer at 8 + k, the SM id at 16
__device__ __forceinline__ void stamp(int k) {
  if (g_stamps == nullptr || threadIdx.x != 0) return;
  unsigned long long t, *row = g_stamps + (size_t)blockIdx.x * 24;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  row[k] = clock64();
  row[8 + k] = t;
  if (k == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    row[16] = sm;
  }
}
"""


def instrumented(src, cluster):
    """The kernel source with its phase stamps, at ``cluster`` blocks a row
    where given."""
    if cluster is not None:
        old = src[src.index("constexpr int kCluster = "):]
        old = old[:old.index(";") + 1]
        src = src.replace(old, f"constexpr int kCluster = {cluster};")
    src = src.replace("namespace {\n", "namespace {\n" + STAMP, 1)
    src = src.replace("  const int r = blockIdx.x / kCluster;\n",
                      "  stamp(0);\n  const int r = blockIdx.x / kCluster;\n",
                      1)
    for k, anchor in enumerate(ANCHORS, start=1):
        if anchor not in src:
            raise SystemExit(f"wide_timeline: no {anchor.strip()!r} in the "
                             "kernel source; update ANCHORS")
        src = src.replace(anchor, f"  stamp({k});\n" + anchor, 1)
    # the end: the forward's return, the backward's last store
    src = src.replace("    if (rank == 0 && tid == 0) finish_row(",
                      "    stamp(6);\n    if (rank == 0 && tid == 0) "
                      "finish_row(", 1)
    tail = "o[j] = value(j, src[j]);\n  }\n}\n"
    if tail not in src:
        raise SystemExit("wide_timeline: the backward's end moved; update "
                         "the end stamp")
    src = src.replace(tail, "o[j] = value(j, src[j]);\n  }\n  stamp(6);\n}\n",
                      1)
    return src + ('\nextern "C" int set_stamps(void* p) {\n'
                  "  return (int)cudaMemcpyToSymbol(g_stamps, &p, "
                  "sizeof(p));\n}\n")


def build(src):
    from repro_torch.kernels import build as kbuild
    out = ROOT / "build" / "wide_timeline"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mpce.cu").write_text(src)
    proc = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS,
                           f"-I{kbuild.CSRC}", "-o", str(out / "mpce.so"),
                           str(out / "mpce.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"wide_timeline: nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out / "mpce.so"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.masked_pseudo_ce_wide_launch.argtypes = [P, P, P, I, I, F, P]
    lib.masked_pseudo_ce_wide_bwd_launch.argtypes = [P, P, P, P, I, I, P]
    lib.set_stamps.argtypes = [P]
    for fn in (lib.masked_pseudo_ce_wide_launch,
               lib.masked_pseudo_ce_wide_bwd_launch, lib.set_stamps):
        fn.restype = ctypes.c_int
    return lib


def timeline(rows):
    """Blocks an SM, start / end spread (us) and each phase's median and
    largest time (us) over the blocks."""
    per_sm = Counter(Counter(r[16] for r in rows).values())
    g0 = min(r[8] for r in rows)
    phases = {}
    for k, name in enumerate(PHASES, start=1):
        d = [(r[k] - r[k - 1]) * (r[14] - r[8]) / (r[6] - r[0]) / 1e3
             for r in rows]
        phases[name] = {"median_us": statistics.median(d), "max_us": max(d)}
    return {"sms": len({r[16] for r in rows}),
            "blocks_per_sm": dict(sorted(per_sm.items())),
            "start_us": [0.0, (max(r[8] for r in rows) - g0) / 1e3],
            "end_us": [(min(r[14] for r in rows) - g0) / 1e3,
                       (max(r[14] for r in rows) - g0) / 1e3],
            "phases": phases}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cluster", type=int)
    ap.add_argument("--shapes", default="16x151936,96x151936")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("wide_timeline: CUDA is not available")
    from repro_torch.kernels import ops, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    src = (ROOT / "src/repro_torch/kernels/csrc/masked_pseudo_ce.cu"
           ).read_text()
    lib = build(instrumented(src, args.cluster))
    cluster = args.cluster or ops.WIDE_CLUSTER
    print(f"{smi}; cluster {cluster}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flushes = cs.l2_flushes(torch, dev)
    stream = torch.cuda.current_stream().cuda_stream
    lt = ref.log_threshold(cs.THETA)
    report = {"gpu": smi, "cluster": cluster, "shapes": []}
    for shape in args.shapes.split(","):
        n, c = (int(v) for v in shape.split("x"))
        bounds = ops.wide_plan(c, cluster)["bounds"]
        x = cs._wide_logits(torch, bounds, gen, dev, n, c)
        g = torch.rand((n,), generator=gen, device=dev)
        want_loss, mask = ref.masked_pseudo_ce_ref(x, cs.THETA)
        want_grad = ref.masked_pseudo_ce_grad(x, mask, g)
        loss, mask_out = torch.empty_like(want_loss), torch.empty_like(mask)
        grad = torch.empty_like(x)
        stamps = torch.zeros((n * cluster, 24), dtype=torch.int64,
                             device=dev)
        calls = {
            "forward": (lambda: lib.masked_pseudo_ce_wide_launch(
                x.data_ptr(), loss.data_ptr(), mask_out.data_ptr(), n, c,
                lt, stream), lambda: cs._same_bits(torch, loss, want_loss)),
            "backward": (lambda: lib.masked_pseudo_ce_wide_bwd_launch(
                x.data_ptr(), mask.data_ptr(), g.data_ptr(),
                grad.data_ptr(), n, c, stream),
                lambda: cs._same_bits(torch, grad, want_grad))}
        for what, (call, same) in calls.items():
            cs.check(lib.set_stamps(0) == 0 and call() == 0,
                     f"{what} ({n}, {c}) did not launch")
            torch.cuda.synchronize()
            cs.check(same(), f"{what} ({n}, {c}) differs from the plain "
                     "version's bits")
            ms = cs.profile_call(torch, call, reps=30,
                                 flush=flushes.clean)["device_ms"]
            runs = []
            for _ in range(args.reps):
                flushes.clean()
                stamps.zero_()
                torch.cuda.synchronize()
                lib.set_stamps(stamps.data_ptr())
                call()
                torch.cuda.synchronize()
                lib.set_stamps(0)
                runs.append(timeline(stamps.cpu().tolist()))
            report["shapes"].append({"shape": [n, c], "direction": what,
                                     "device_ms": ms, "stamped": runs})
            print(f"({n}, {c}) {what}: device {ms:.5f} ms a call (no "
                  f"stamps), bits equal", flush=True)
            for t in runs:
                print(f"    {t['sms']} SMs, blocks an SM {t['blocks_per_sm']}"
                      f"; starts {t['start_us'][1]:.2f} us apart, ends "
                      f"{t['end_us'][0]:.2f}-{t['end_us'][1]:.2f} us; "
                      + "; ".join(f"{k} {v['median_us']:.2f} (max "
                                  f"{v['max_us']:.2f})"
                                  for k, v in t["phases"].items()),
                      flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()

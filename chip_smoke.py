#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout, on a machine with one CUDA card (an H100 is what the
numbers in PERF.md were taken on). Phases, each of which raises on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc,
   one process per source, all started together;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the paths of phases 5 and 6 give it and at ragged edges (the
   ``masked_pseudo_ce`` mask and backward and every compaction kernel bit
   for bit), and time kernel, plain version and (where one exists) the
   single PyTorch call computing the same function, with CUDA events
   (median over repeats); time one call of ``masked_pseudo_ce`` (forward
   and backward) and of ``flash_attention`` by torch.profiler too:
   device time, device ops and host time a call; the memory-bound
   kernels (``csr_compact``, ``staleness_agg``, ``sparse_delta``,
   ``csr_quant``) the same, the L2
   flushed before each repeat by a read of 96 MB that leaves no dirty
   line, and again under the writing flush of earlier versions, whose
   write-back the timed call pays; fail unless ``csr_quant`` is one
   device op a call; print the bf16 flash kernel's ptxas report and fail
   if ``flash_attention.so`` holds no HGMMA (wgmma) instruction; then
   hold ``csr_compact``, ``csr_quant`` (int8, fp16) and ``staleness_agg``
   bit for bit at every chunk width of the slice layout (``CHUNK``: the
   paper CNN in 9 leaf-aligned chunks, conv and out kept at 0.5) at K = 6
   and K = 1, and all nine chunks' calls of a round back to back on one
   stream, and time one call of each at three chunk widths; then hold
   ``csr_compact``, ``csr_quant``, ``sparse_delta`` and ``staleness_agg``
   bit for bit at every K a degraded round gives them (2-5), at (K, N)
   and every chunk width, each K's calls back to back; and the same four
   at (K, N) for every row count a dense-store distribution gives them (1
   and 6-10); then the FL language-model path's: the vocabulary-wide
   ``masked_pseudo_ce`` kernels (a cluster of 6 blocks a row) forward,
   mask and backward bit for bit at (16, 151936), (96, 151936), (1,
   151936), (7, 1025) (rows not 16-byte aligned) and (3, 600000) (slices
   read from device memory in each pass), confident rows, ties and ties
   across a slice boundary planted, the first two timed alone beside
   ``torch.log_softmax`` / ``torch.softmax``; ``csr_compact`` at (1, N)
   and (6, N) and ``staleness_agg`` at (1-6, N) at phase 5h's flat widths
   (up to N = 420,566,528: 2.52e9 elements in six rows); and at phase 5i's
   chunk widths (LC's layouts at 4 and 2 layers and L0c's, derived from
   the layouts as ``chunk_plan`` derives them) ``csr_compact`` (upload at cap,
   EF residual at rcap, chain advance) and ``staleness_agg`` bit for bit at
   K = 6, 1 and ``FAULT_KS``, each K's calls back to back, one call of
   each timed at each distinct LC width (K = 6); the narrow ``masked_pseudo_ce``
   rows beside ``torch.log_softmax(x).max(1)`` and ``torch.softmax``;
   then phase 5j's: ``masked_pseudo_ce`` on bf16 logits at (16, 151936)
   and (16, 9), forward and backward, the gradient in bf16, bit for bit
   (the narrow loss within 1e-6); ``sparse_delta`` at (6, N) and (1, N)
   and fp16 ``csr_quant`` at (6, cap) and (1, cap) for the 2-layer N =
   326,970,880, bit for bit row by row and timed; and at J0's width every
   compaction kernel at 1-8 rows and the narrow ``masked_pseudo_ce`` at
   (16, 512);
4. run the port's sequential engine twice on the card and once on the CPU
   from the same initial weights (full-width paper CNN, dropout 0,
   2 rounds) and compare schedules, parameters, metrics and ACO; then
   card and CPU once more with an absolute threshold, elementwise; then
   the batched engine against the sequential one, both on the card, with
   the default dropout, on the p0.2 wire, with the absolute threshold, and
   on the csr_q wire with error feedback; and the chunked trainer on the
   card against the CPU (sequential engine, 2 rounds) on the same
   criteria;
4c. run the paper's four comparison baselines (FedAvg-SSL partial and
   all, FedAsync-SSL, Local-SSL) on the card and on the CPU at full width
   from the same initial weights (dropout 0, scale 0.02, 2 rounds,
   FedAsync-SSL 8 arrivals): selections, arrivals, ART, forced syncs and
   ACO exact, parameters within atol 1e-4 / rtol 1e-3, metrics 1e-4;
   Local-SSL update by update from the CPU's state, with a trace of its
   pseudo-label decisions (argmax and mask): a row whose decision
   differs from the CPU's from equal state away from a rounding tie
   fails; the first differing decision of a free run on the card beside
   the CPU's is recorded;
5. drive six paths at full width, ``FedS3ATrainer(make_dataset("basic",
   scale=0.02), FedS3AConfig(rounds=3, engine=..., wire_format=...,
   error_feedback=...))`` on the card: sequential + csr, batched + csr
   (the default), batched + dense_masked, sequential + dense_masked, and
   batched and sequential on csr_q with error feedback, each with the
   launch counters reset just before it and read just after, failing if
   a kernel of the path never launched, a kernel off the path did, the
   ``masked_pseudo_ce`` backward launched other than once a forward, or
   ``csr_compact`` (and on the csr_q paths ``csr_quant``) other than its
   exact count a round; then run one more round of each path
   under ``torch.profiler`` and print the device's busy share and its
   heaviest kernels; then three paths with the participant-paged client
   store (sequential and batched csr_q + EF, batched dense_masked + EF),
   each right after its resident twin under the same launch rules, and
   fail unless the two are equal bit for bit (accuracy, ACO, participants
   a round, a digest of the global parameters); then four chunked paths
   (batched csr, batched and sequential csr_q + EF, batched csr_q + EF
   paged) at 9x the flat batched round's encode launches, the
   sequential and paged runs equal to the batched resident one bit for
   bit, and ``chunk_size=6_000_000`` equal to the flat batched csr run;
5c. run the four baselines at full width on the card (dropout 0.1, 3
   rounds, FedAsync-SSL 12 arrivals): ``masked_pseudo_ce`` (and its
   backward) once a client step, ``staleness_agg`` once a FedAvg round and
   never otherwise, no compaction kernel;
5d. the fleet, batched + csr + EF on ``make_fleet_dataset(M, pool=64,
   scale=0.001)``: M = 1,000 at full width with 64 participants a round,
   resident then paged, bit for bit; then M = 1,000,000 at the fleet width
   (conv 8/8, hidden 16) with 512 participants, paged (1 warm-up round, 2
   timed), whose client state on the device must equal that of M = 1,000
   with the same participants; (iii) M = 1,000 at full width chunked,
   resident then paged, bit for bit, whose upload-encode stage's own
   peak device memory must be below the flat resident run's;
5f. faults and fleet checkpoints: six runs at full width, 7 rounds each
   under ``REFERENCE_CHURN`` with 5% corrupt uploads, a 700 s deadline
   and a quorum floor of 2 (batched and sequential csr, batched csr_q +
   EF resident, paged and chunked, batched dense_masked + EF), each with
   the launch counters reset just before it and every count held to its
   table at that run's own K a round; every trace (participants,
   stalenesses, crashes, lost, quarantined, departed, rejoined, resynced,
   quorum, times) equal to the first run's and to its CPU twin's (a
   subprocess, ``--fault-traces``, the same configs at a reduced CNN);
   paged == resident and chunked sequential == batched bit for bit;
   batched against sequential within the stacked-engine tolerance; three
   runs saved at round 3, restored onto fresh trainers and finished, bit
   for bit (parameters, ring, versions, detached mask, residual pages,
   trace, ACO, fleet), with checkpoint bytes and save, exposure and
   restore seconds printed; one run with ``checkpoint_every=5`` through
   ``train()``; every checkpoint under a temporary directory it removes;
5g. the dense base store (``base_store="dense"``, the paper's own
   distribution) on phase 5's model and data, 3 rounds a run: G1
   sequential + csr, G2 batched + csr, G3 batched + csr_q + EF, G4
   sequential + dense_masked, G5 G1 at ``epochs=2``, G6 G2 at ``tau=0``
   (four forced clients a round: T = 10 targets), each with the launch
   counters set to 0 just before it and every count held to its exact
   value from each round's K participants and T targets, each beside its
   versioned twin's ACO; G0, sparse_comm off on each engine, dense against
   versioned bit for bit (digest, ACO, metrics, versions); G1 against G2,
   and G1's setting for 2 rounds at dropout 0 on the card against the
   CPU; every row count the runs launched a compaction kernel at must be
   one phase 3 held;
5h. the FL language-model path: qwen2-1.5b at every published width, 4
   of 28 layers (2 if the batched run's peak passes 70 GB), bf16 compute,
   federated as a final-token classifier (``FedS3AConfig(model=...)``,
   ``make_lm_dataset``, 3 rounds): L2 batched and L1 sequential csr, each
   with exact launches and the rows Eq. 5 kept; L0, reduced widths with
   the full vocabulary in float32, on the card against its CPU twin (a
   subprocess started at the phase's start); every (kernel, rows, width)
   launched must be one phase 3 held;
5i. the chunked, faulted, checkpointed FL language model: LC, phase 5h's
   L2 setting (4 of 28 layers, or 2 if its peak passes 70 GB) on the
   chunked parameter axis in chunks of ceil(N / 6), csr + EF, with the
   example's faults (5% crashes, 5% lost uploads, a 2,000 s deadline, a
   quorum floor of 1; ``examples/fl_large_model.py``), 4 rounds, the rounds
   of the first crash and lost upload printed; LCs, the same on the
   sequential engine, equal to LC bit for bit; each held to its exact
   launches by (kernel, rows, width) from each round's K and the chunk
   plan, with its peak device memory, the upload stage's own peak and the
   reference's analytic ``peak_delta_device_bytes``; L0c, L0's model with
   LC's settings, on the card against its CPU twin (a subprocess started
   with phase 5h, whose wall time is the card's; traces exact, L0's
   bounds) and saved after 3
   rounds (``wait=False``, a round run at once), restored onto a fresh
   trainer, saved again (``wait=True``), restored onto a third and
   finished, both bit for bit against the uninterrupted run (checkpoint
   bytes, save, exposure and restore seconds printed; the directory
   removed); F2, ``python -m repro_torch.launch.fl_large_model`` at its
   defaults; every (kernel, rows, width) launched must be one phase 3
   held;
5j. the FL language model on the other wires and options, phase 5h's
   setting run directly at 2 layers (N = 326,970,880), 3 rounds each: J1
   batched + dense_masked, J2 sequential + fp16 csr_q + EF over 2 epochs,
   J3 batched on the disabled channel over 2 epochs, each with its peak
   reckoned from phase 5h's before it and measured after (under 70 GB)
   and its exact launches by (kernel, rows, width); J0,
   ``tests/test_torch_lm_trainer.py``'s lm-small run with each option
   (dense_masked, disabled, fp16 csr_q + EF, 2 epochs) on both engines,
   the card against the CPU in this process at that test's bounds; every
   (kernel, rows, width) launched must be one phase 3 held;
6. serve qwen2-1.5b at full width (random weights, bf16): 8 requests
   of 512-2048 tokens, bucket 2048, 32 new tokens, through
   ``serve_batch`` with the flash kernel, the counters showing exactly
   one ``flash_attention`` launch per layer per call; the prefill's last
   logits with the kernel against the plain attention on the card, and a
   2-layer float32 model of the same width on the card against the CPU;
6b. train qwen2-1.5b (``training/steps.py``, ``impl="flash"``, remat):
   T0, the full width at 2 layers in float32 (B 2, S 1024: a 2 x 2 grid
   of 512-wide tiles), ``lm_loss`` and its gradients with
   ``impl="flash"`` against ``impl="ref"`` (loss 1e-5 relative, each
   leaf's gradient 1e-4 in relative L2 norm), and one train step of 2
   microbatches against 1 (loss 1e-6 relative, Adam's first moment, 0.1
   x the gradient, 1e-4 per leaf in relative L2 norm, parameters within 2
   lr and at most 0.1% of them past 1e-6); T0c,
   ``tests/test_torch_train_step.py``'s reduced model, 2 flash steps of 2
   microbatches, card against CPU (losses 1e-5; parameters atol 1e-4 /
   rtol 1e-3 but for Adam sign flips within 2 lr a step, at most 0.1% of
   them); T1, the whole
   model (all 28 layers, N = 1,543,714,304, bf16 compute) through
   ``launch/train.py``'s ``run_lm(reduced=False)``, batch 8 x 2048 in 4
   microbatches, a warm-up step and 3 timed ones (seconds, tokens/s,
   loss, model-FLOP share of the bf16 peak; finite losses, every leaf
   moved, peak memory under 75 GB); F1, ``python -m
   repro_torch.launch.train fl`` (phase 5's batched + csr setting: its
   checkpoint's parameters must have that run's digest) and ``lm`` as
   subprocesses, the checkpoint under a temporary directory it removes;
7. print one ``{"kernels": [...], "paths": ..., "serve": ...,
   "baselines": ..., "baselines_card_vs_cpu": ..., "chunked_card_vs_cpu":
   ..., "fleet": ..., "faults": ..., "dense_store": ..., "lm_path": ...,
   "lm_chunked": ..., "lm_options": ..., "lm_train": ...}`` line, then the
   result line
   ``{"ok": true, "device": {...}}`` last.

It exits non-zero, printing no result, when CUDA is unavailable or the
port's sources are missing. It imports nothing from the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor-core rate, dense
THETA = 0.95
N_FULL = 5_213_449            # paper CNN parameter count
CAP_FULL = 2_606_725          # min(N, ceil(2.5 * 0.2 * N))
RCAP_FULL = 1_303_363         # ceil(0.25 * N), the EF residual's capacity


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def bound_ms(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    """Least time for the work: the larger of bytes over the memory rate and
    operations over the rate for their type (float32 unless given), with
    which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, *, reps, flush=None):
    """Median device time of ``fn()`` over ``reps`` repeats, each between
    two CUDA events; ``flush()`` (outside the events) evicts the L2."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


L2_FLUSH_SHAPE = (24_576, 1024)   # int32, 96 MB: about twice the L2


def l2_flushes(torch, dev):
    """Two ways to evict the card's 50 MB L2 before a timed call, each one
    device op: ``clean`` reads a 96 MB buffer (a row max into 96 KB), so
    the lines it leaves in L2 are clean and the timed call writes none of
    them back; ``write``, the flush of earlier versions, inverts the buffer
    in place and leaves up to the whole L2 dirty, whose write-back the
    timed call then pays. Each carries ``kernel``, the profiler's name of
    its device op, which ``profile_call`` leaves out of a call's time."""
    scratch = torch.arange(L2_FLUSH_SHAPE[0] * L2_FLUSH_SHAPE[1],
                           dtype=torch.int32, device=dev).view(
                               L2_FLUSH_SHAPE)
    rowmax = torch.empty(L2_FLUSH_SHAPE[0], dtype=torch.int32, device=dev)

    def clean():
        torch.amax(scratch, dim=1, out=rowmax)

    def write():
        torch.bitwise_not(scratch, out=scratch)

    for flush in (clean, write):
        flush.kernel = _only_device_op(torch, flush)
    return SimpleNamespace(clean=clean, write=write)


def _only_device_op(torch, fn):
    """The profiler's name of the one device op ``fn()`` runs; fails if it
    runs another number of them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda and
            e.self_device_time_total > 0]
    check(len(rows) == 1 and rows[0].count == 1,
          f"an L2 flush runs {[(e.key, e.count) for e in rows]}, not one "
          "device op")
    return rows[0].key


def profile_call(torch, fn, *, reps, flush=None):
    """One call of ``fn()`` on the card: its device time (the sum of its
    device ops' times in torch.profiler, ms), the device ops it runs and
    their names, each a mean over ``reps`` calls (``flush()`` before each,
    its kernel ``flush.kernel`` left out; fails if the flush's kernel ran
    more often than the flush, i.e. if a measured op shares its name); and
    its host time (ms of host clock to issue one call, over ``reps`` calls
    issued back to back without a synchronise). A trace can lose an event:
    the calls are counted as the most launches of one op, the flush's or a
    measured one's, and at most ``reps``, so that one lost event of either
    kind does not divide by too few calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda and
            e.self_device_time_total > 0]
    calls = reps
    if flush is not None:
        flushed = sum(e.count for e in rows if e.key == flush.kernel)
        check(flushed <= reps, f"the flush's kernel ran {flushed} times "
              f"for {reps} flushes: a measured op shares its name")
        rows = [e for e in rows if e.key != flush.kernel]
        calls = min(reps, max([flushed, *(e.count for e in rows)])) or reps
    names = {}
    for e in rows:
        names[e.key[:80]] = names.get(e.key[:80], 0) + e.count / calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return {"device_ms": sum(e.self_device_time_total for e in rows)
            / 1e3 / calls,
            "device_ops": sum(e.count for e in rows) / calls,
            "device_op_names": names, "traced_calls": calls,
            "host_ms": host_ms}


def memory_bound_call(torch, fn, nbytes, nops, flushes, *, reps=30):
    """A memory-bound kernel's call, the L2 flushed before each: ``ms`` is
    its device time under the clean flush (torch.profiler; a CUDA-event
    interval around a call that is short beside its host time measures the
    host whenever the flush ends first), with device ops and host time a
    call; beside it the device time under the writing flush and the
    CUDA-event medians under both, and the bound."""
    b, by = bound_ms(nbytes, nops)
    clean = profile_call(torch, fn, reps=reps, flush=flushes.clean)
    return {"ms": clean["device_ms"], **clean,
            "device_ms_write_flush": profile_call(
                torch, fn, reps=reps, flush=flushes.write)["device_ms"],
            "event_ms": time_ms(torch, fn, reps=reps, flush=flushes.clean),
            "event_ms_write_flush": time_ms(torch, fn, reps=reps,
                                            flush=flushes.write),
            "bound_ms": b, "bound_by": by}


def _timed(torch, kernel, plain, nbytes, nops, *, reps, plain_reps=None,
           flushes=None, library=None):
    """Kernel, plain-version and library times (ms) and the bound; with
    ``flushes``, the L2 flushed (clean) before each repeat, and the kernel
    measured by ``memory_bound_call``."""
    flush = None if flushes is None else flushes.clean
    b, by = bound_ms(nbytes, nops)
    kern = {"ms": time_ms(torch, kernel, reps=reps), "bound_ms": b,
            "bound_by": by} if flushes is None else \
        memory_bound_call(torch, kernel, nbytes, nops, flushes, reps=reps)
    return {**kern,
            "plain_ms": time_ms(torch, plain, reps=plain_reps or reps,
                                flush=flush),
            "library_ms": None if library is None else
            time_ms(torch, library, reps=reps, flush=flush)}


def _mpce_logits(torch, gen, dev, n, c):
    """(n, c) logits: random rows, every 7th with its maximum tied at a
    later column, every 5th with a max softmax of theta (1 +- 2e-5), far
    enough from theta that the kernel and the plain version, whose sums
    round differently, mask it alike."""
    x = torch.randn((n, c), generator=gen, device=dev) * 3
    x[::7, c - 1] = x[::7].max(dim=1).values
    rows = x[2::5]
    d = torch.where(torch.arange(len(rows), device=dev) % 2 == 0, 2e-5,
                    -2e-5)
    # logits (0, b, ..., b): 1 / (1 + (c - 1) e^b) = theta (1 + d)
    b = torch.log((1 / (THETA * (1 + d)) - 1) / (c - 1))
    x[2::5] = b[:, None].expand(-1, c).clone()
    x[2::5, 0] = 0.0
    return x


def _mpce_call(torch, fwd, bwd, logits, g):
    """Forward and backward of the Eq. 5 loss through autograd, as a client
    step runs them; ``bwd`` None: the autograd Function's own backward."""
    if bwd is not None:
        loss, mask = fwd(logits, THETA)
        return loss, mask, bwd(logits, mask, g)
    lk = logits.detach().requires_grad_(True)
    loss, mask = fwd(lk, THETA)
    torch.autograd.backward(loss, g)
    return loss, mask, lk.grad


def check_masked_pseudo_ce(torch, ops, ref, dev, gen):
    """Forward: loss within 1e-6 of the plain version, mask bit for bit.
    Backward kernel: bit for bit the plain gradient on the card, through
    autograd and called alone. Then per call at the path shapes, forward
    and backward together: device time and ops (torch.profiler), host
    time, against the plain version's."""
    worst = 0.0
    # (16, 512): phase 5j's J0, the lm-small LM's client and server steps
    for n, c in ((600, 9), (100, 9), (4096, 9), (300, 40), (LM_B, 512)):
        logits = _mpce_logits(torch, gen, dev, n, c)
        g = torch.rand((n,), generator=gen, device=dev)
        loss_k, mask_k, grad_k = _mpce_call(torch, ops.masked_pseudo_ce,
                                            None, logits, g)
        loss_p, mask_p = ref.masked_pseudo_ce_ref(logits, THETA)
        grad_p = ref.masked_pseudo_ce_grad(logits, mask_k, g)
        grad_d = ops.masked_pseudo_ce_grad(logits, mask_k, g)
        torch.cuda.synchronize()
        err = float((loss_k - loss_p).detach().abs().max())
        same = [_same_bits(torch, mask_k, mask_p),
                _same_bits(torch, grad_k, grad_p),
                _same_bits(torch, grad_d, grad_p)]
        masked = int(mask_k.sum())
        log(f"  masked_pseudo_ce ({n}, {c}): max |loss - plain| {err:.3g}; "
            f"same bits as plain (mask, grad through autograd, grad alone) "
            f"{same}; {masked} of {n} rows masked in")
        check(err <= 1e-6, f"masked_pseudo_ce ({n}, {c}) loss off by {err}")
        check(all(same), f"masked_pseudo_ce ({n}, {c}): mask or gradient "
              "differs from the plain version's bits")
        check(0 < masked < n, "masked_pseudo_ce: no row on one side of theta")
        worst = max(worst, err)
    fwd_bwd, bwd = [], []
    # (600, 9): a batched step, all 6 clients' rows; (100, 9): a sequential
    # step, one client's batch. A call moves the logits and g in, loss,
    # mask and gradient out; the backward alone logits, mask and g in.
    for n, c in ((600, 9), (100, 9)):
        logits = _mpce_logits(torch, gen, dev, n, c)
        g = torch.rand((n,), generator=gen, device=dev)
        mask = ops.masked_pseudo_ce(logits, THETA)[1]
        kern = profile_call(torch, lambda: _mpce_call(
            torch, ops.masked_pseudo_ce, None, logits, g), reps=200)
        plain = profile_call(torch, lambda: _mpce_call(
            torch, ref.masked_pseudo_ce_ref, ref.masked_pseudo_ce_grad,
            logits, g), reps=200)
        # the library's nearest calls: the forward's max log-probability,
        # the backward's softmax
        lib_fwd = profile_call(torch, lambda: torch.log_softmax(
            logits, dim=1).max(dim=1), reps=200)
        lib_bwd = profile_call(torch, lambda: torch.softmax(logits, dim=1),
                               reps=200)
        b, by = bound_ms(8 * n * c + 12 * n, 11 * n * c + 7 * n)
        fwd_bwd.append({
            "shape": [n, c], "ms": kern["device_ms"],
            "plain_ms": plain["device_ms"],
            "library_ms": lib_fwd["device_ms"] + lib_bwd["device_ms"],
            "library_how": "torch.log_softmax(x).max(1) + torch.softmax(x)",
            "library_forward_ms": lib_fwd["device_ms"],
            "bound_ms": b, "bound_by": by, **kern,
            "plain_device_ops": plain["device_ops"],
            "plain_host_ms": plain["host_ms"]})
        kb = profile_call(torch, lambda: ops.masked_pseudo_ce_grad(
            logits, mask, g), reps=200)
        pb = profile_call(torch, lambda: ref.masked_pseudo_ce_grad(
            logits, mask, g), reps=200)
        b, by = bound_ms(8 * n * c + 8 * n, 7 * n * c + n)
        bwd.append({"shape": [n, c], "ms": kb["device_ms"],
                    "plain_ms": pb["device_ms"],
                    "library_ms": lib_bwd["device_ms"],
                    "library_how": "torch.softmax(x)",
                    "bound_ms": b, "bound_by": by, **kb,
                    "plain_device_ops": pb["device_ops"],
                    "plain_host_ms": pb["host_ms"]})
    return [{"name": "masked_pseudo_ce", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/masked_pseudo_ce.cu",
             "replaces": "src/repro/kernels/masked_pseudo_ce.py:33",
             "timed": "forward and backward through autograd",
             "max_abs_err": worst, **fwd_bwd[0],
             "other_shapes": fwd_bwd[1:]},
            {"name": "masked_pseudo_ce_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/masked_pseudo_ce.cu",
             "replaces": "src/repro/kernels/ops.py:51 (_mpce_bwd, the "
                         "plain-jnp backward of masked_pseudo_ce_pallas)",
             "max_abs_err": 0.0, **bwd[0], "other_shapes": bwd[1:]}]


def _same_bits(torch, a, b):
    """Equal shape, type and bits (signed zeros included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {torch.float32: torch.int32, torch.float16: torch.int16,
              torch.bfloat16: torch.int16}
    if a.dtype in as_int:
        return torch.equal(a.view(as_int[a.dtype]), b.view(as_int[b.dtype]))
    return torch.equal(a, b)


def _delta(torch, gen, dev, k, n):
    """(k, n) update-sized deltas, a tenth of them exact zeros."""
    x = torch.randn((k, n), generator=gen, device=dev) * 1e-3
    zeros = torch.rand((k, n), generator=gen, device=dev) < 0.1
    return x.masked_fill(zeros, 0.0)


def csr_compact_call(torch, ops, x, thr, cap, flushes):
    """One ``csr_compact`` call at (K, N), measured by
    ``memory_bound_call``; the bound counts x read once and every slot of
    vals and idx written once, the zero tail included."""
    k, n = x.shape
    return memory_bound_call(
        torch, lambda: ops.csr_compact(x, thr, cap),
        4 * k * n + 4 * k + 8 * k * cap + 4 * k, 3 * k * n, flushes)


def check_csr_compact(torch, ops, ref, comm_mod, dev, gen, flushes):
    x6 = _delta(torch, gen, dev, 6, N_FULL)
    thr6 = comm_mod.local_quantile_thresholds(x6, 0.2)
    x = x6[:1].clone()
    thr = thr6[:1].clone()
    cases = [("batched upload", x6, thr6, CAP_FULL),
             ("sequential upload / chain advance", x, thr, CAP_FULL)]
    nnz_main = int(ref.csr_compact2d_ref(x, thr, CAP_FULL)[2][0])
    cases.append(("overflow cap < nnz", x, thr, max(nnz_main // 3, 1)))
    # the EF residual: what the payload left, cut at ceil(0.25 N)
    xres = x6 - ref.csr_capped_mask_ref(x6, thr6, CAP_FULL)[0]
    thr_res = comm_mod.local_quantile_thresholds(xres, 0.25)
    cases.append(("EF residual (6, N)", xres, thr_res, RCAP_FULL))
    cases.append(("thr <= 0, exact zeros", x,
                  torch.tensor([-1.0], device=dev), CAP_FULL))
    xr = _delta(torch, gen, dev, 3, 1_000_003)
    cases.append(("ragged (3, 1000003)", xr,
                  comm_mod.local_quantile_thresholds(xr, 0.2), 400_001))
    for label, xx, tt, cap in cases:
        vk, ik, nk = ops.csr_compact(xx, tt, cap)
        vp, ip, np_ = ref.csr_compact2d_ref(xx, tt, cap)
        torch.cuda.synchronize()
        same = torch.equal(vk, vp) and torch.equal(ik, ip) and \
            torch.equal(nk, np_)
        log(f"  csr_compact {label}: shape {tuple(xx.shape)}, cap {cap}, "
            f"nnz {nk.tolist()}, bit-exact {same}")
        check(same, f"csr_compact {label}: kernel differs from plain")
    shapes = []
    for label, xx, tt, cap in (cases[0], cases[1], cases[3]):
        shapes.append({"shape": list(xx.shape), "case": label, "cap": cap,
                       **csr_compact_call(torch, ops, xx, tt, cap, flushes),
                       "plain_ms": time_ms(
                           torch, lambda: ref.csr_compact2d_ref(xx, tt, cap),
                           reps=10, flush=flushes.clean),
                       "library_ms": None})
    return {"name": "csr_compact", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/csr_compact.cu",
            "replaces": "src/repro/kernels/csr_compact.py:75",
            "max_abs_err": 0.0, **shapes[0], "other_shapes": shapes[1:]}


def check_staleness_agg(torch, ops, ref, dev, gen, flushes):
    worst, shapes = 0.0, []
    # (6, N): the batched base sum and FedAvg-SSL-Partial; (3, N): the
    # sequential group sums; (10, N): FedAvg-SSL-All's ten clients
    for k in (6, 3, 10):
        d = torch.randn((k, N_FULL), generator=gen, device=dev) * 1e-2
        w = torch.rand((k,), generator=gen, device=dev)
        w = w / w.sum()
        out_k = ops.staleness_agg(d, w)
        out_p = ref.staleness_agg_ref(d, w)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        close = torch.allclose(out_k, out_p, rtol=1e-6, atol=0.0)
        log(f"  staleness_agg ({k}, {N_FULL}): max |kernel - plain| = "
            f"{err:.3g}, allclose rtol 1e-6: {close}")
        check(close, f"staleness_agg ({k}, N) off by {err}")
        worst = max(worst, err)
        shapes.append({"shape": [k, N_FULL], **_timed(
            torch, lambda: ops.staleness_agg(d, w),
            lambda: ref.staleness_agg_ref(d, w),
            (k + 1) * 4 * N_FULL + 4 * k, 2 * k * N_FULL, reps=30,
            flushes=flushes, library=lambda: w @ d)})
    return {"name": "staleness_agg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/staleness_agg.cu",
            "replaces": "src/repro/kernels/staleness_agg.py:28",
            "max_abs_err": worst, **shapes[0], "other_shapes": shapes[1:]}


def check_sparse_delta(torch, ops, ref, dev, gen, flushes):
    """Bit for bit (signed zeros included) at the dense_masked paths'
    shapes, a ragged row length, thr <= 0 and exact zeros."""
    x6 = _delta(torch, gen, dev, 6, N_FULL)
    xr = _delta(torch, gen, dev, 3, 1_000_003)
    xz = _delta(torch, gen, dev, 2, N_FULL)
    xz[0, ::3] = -0.0
    cases = [
        ("batched upload, top 20%", x6, None),
        ("ragged (3, 1000003), top 20%", xr, None),
        ("thr <= 0 and exact zeros", xz, torch.tensor([0.0, -1.0],
                                                      device=dev)),
        ("absolute threshold", x6, torch.full((6,), 1e-3, device=dev))]
    for label, xx, tt in cases:
        if tt is None:
            mk, nk, tt = ops.sparse_delta_topfrac(xx, 0.2)
        else:
            mk, nk = ops.sparse_delta_batch(xx, tt)
        mp, np_ = ref.sparse_delta2d_ref(xx, tt)
        torch.cuda.synchronize()
        ok = _same_bits(torch, mk, mp) and torch.equal(nk, np_)
        log(f"  sparse_delta {label}: shape {tuple(xx.shape)}, survivors "
            f"{nk.sum(dim=1).tolist()}, bit-exact {ok}")
        check(ok, f"sparse_delta {label}: kernel differs from plain")
        if label.startswith("thr <= 0"):
            check(int(nk[0].sum()) == N_FULL, "sparse_delta thr <= 0 must "
                  "keep every column and count no pad")
    # the K = 1 form: a sequential upload, the chain advance
    x1 = x6[0].clone()
    t1 = ref.local_quantile_thresholds(x1[None], 0.2, fused="high")
    m1, n1 = ops.sparse_delta(x1, t1)
    p1, q1 = ref.sparse_delta_ref(x1, t1)
    torch.cuda.synchronize()
    ok = _same_bits(torch, m1, p1) and torch.equal(n1, q1)
    log(f"  sparse_delta (1, N) one message: survivors {int(n1.sum())}, "
        f"bit-exact {ok}")
    check(ok, "sparse_delta (1, N): kernel differs from plain")
    shapes = []
    for xx in (x6, x6[:1].clone()):
        k = xx.shape[0]
        tt = ref.local_quantile_thresholds(xx, 0.2)
        nblk = -(-N_FULL // 512)
        shapes.append({"shape": [k, N_FULL], **_timed(
            torch, lambda: ops.sparse_delta_batch(xx, tt),
            lambda: ref.sparse_delta2d_ref(xx, tt),
            8 * k * N_FULL + 4 * k * nblk + 4 * k, 2 * k * N_FULL, reps=30,
            flushes=flushes)})
    return {"name": "sparse_delta", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sparse_delta.cu",
            "replaces": "src/repro/kernels/sparse_delta.py:54",
            "max_abs_err": 0.0, **shapes[0], "other_shapes": shapes[1:]}


def _quant_plain(ref, v, i, s, n, q_dtype):
    qvals, scales = ref.csr_quantize2d_ref(v, s, q_dtype=q_dtype)
    offs, counts = ref.csr_pack_indices_ref(i, s, n)
    return qvals, offs, counts, scales


def quant_payload(torch, ops, comm_mod, x, keep, cap):
    """A real csr_q input: ``csr_compact``'s payload of ``x`` at the top
    ``keep`` of each row, with the stored counts cut at ``cap``."""
    v, i, nnz = ops.csr_compact(x, comm_mod.local_quantile_thresholds(
        x, keep), cap)
    return v, i, torch.clamp(nnz, max=cap)


def csr_quant_call(torch, ops, v, i, s, n, q_dtype, flushes):
    """One ``csr_quantize`` call, measured by ``memory_bound_call``; the
    bound counts the stored prefix of values and indices read once and
    every slot of q and offsets, every block count and scale written
    once."""
    k, cap = v.shape
    stored = int(s.sum())
    nblk = -(-n // 512)
    q_bytes = 2 if q_dtype == "fp16" else 1
    return {"stored": stored, "q_dtype": q_dtype, **memory_bound_call(
        torch, lambda: ops.csr_quantize(v, i, s, n, q_dtype=q_dtype),
        8 * stored + 4 * k + (q_bytes + 2) * k * cap + 2 * k * nblk + 4 * k,
        6 * stored + 2 * k * cap, flushes)}


def check_csr_quant(torch, ops, ref, comm_mod, dev, gen, flushes):
    """Bit for bit (q, offsets, block counts, scales) on real csr_compact
    payloads at full width, (6, cap) and (1, cap), a row cut by its
    capacity, an all-zero row, stored = 0, a ragged width, a row whose
    slots all fall in one 512-column block, a row whose stored prefix ends
    on a block's last column, and fp16; then one call at (6, cap) and
    (1, cap) measured, which must be one device op."""
    x6 = _delta(torch, gen, dev, 6, N_FULL)
    v6, i6, s6 = quant_payload(torch, ops, comm_mod, x6, 0.2, CAP_FULL)
    v1, i1, s1 = v6[:1].clone(), i6[:1].clone(), s6[:1].clone()
    cut = max(int(s1[0]) // 3, 1)
    vc, ic, sc = quant_payload(torch, ops, comm_mod, x6[:1].contiguous(),
                               0.2, cut)
    vz, iz, sz = v6[:2].clone(), i6[:2].clone(), s6[:2].clone()
    vz[0] = 0.0                  # an all-zero row with live slots
    sz[1] = 0                    # and a row with nothing stored
    xr = _delta(torch, gen, dev, 3, 1_000_003)
    vr, ir, sr = quant_payload(torch, ops, comm_mod, xr, 0.2, 400_001)
    # row 0: 300 slots, all in block 7; row 1: the prefix ends on the last
    # column of block 4,000, the blocks past it empty
    vb, ib, sb = v6[:2].clone(), i6[:2].clone(), s6[:2].clone()
    ib[0, :300] = 7 * 512 + torch.sort(torch.randperm(
        512, generator=gen, device=dev)[:300]).values.to(torch.int32)
    sb[0] = 300
    edge = int((ib[1, :int(sb[1])] < 4_000 * 512).sum())
    ib[1, edge - 1] = 4_000 * 512 - 1
    sb[1] = edge
    cases = [("batched upload (6, cap)", v6, i6, s6, N_FULL, "int8"),
             ("sequential upload / chain advance (1, cap)", v1, i1, s1,
              N_FULL, "int8"),
             ("cap < nnz", vc, ic, sc, N_FULL, "int8"),
             ("all-zero row, stored = 0", vz, iz, sz, N_FULL, "int8"),
             ("ragged (3, 1000003)", vr, ir, sr, 1_000_003, "int8"),
             ("one block; prefix ending on a block edge", vb, ib, sb,
              N_FULL, "int8"),
             ("fp16 (6, cap)", v6, i6, s6, N_FULL, "fp16"),
             ("fp16 (1, cap)", v1, i1, s1, N_FULL, "fp16"),
             ("fp16 ragged (3, 1000003)", vr, ir, sr, 1_000_003, "fp16"),
             ("fp16 one block; prefix ending on a block edge", vb, ib, sb,
              N_FULL, "fp16")]
    for label, v, i, s, n, q_dtype in cases:
        got = ops.csr_quantize(v, i, s, n, q_dtype=q_dtype)
        want = _quant_plain(ref, v, i, s, n, q_dtype)
        torch.cuda.synchronize()
        same = [_same_bits(torch, a, b) for a, b in zip(got, want)]
        log(f"  csr_quant {label}: shape {tuple(v.shape)}, stored "
            f"{s.tolist()}, bit-exact (q, offsets, counts, scales) {same}")
        check(all(same), f"csr_quant {label}: kernel differs from plain")
        check(torch.equal(got[2].sum(dim=1, dtype=torch.int32), s),
              f"csr_quant {label}: block counts do not sum to stored")
        if label.startswith("all-zero"):
            check(float(got[3][0]) == 0.0 and not bool(got[0][0].any())
                  and not bool(got[2][1].any()),
                  "csr_quant: all-zero row or stored = 0 mishandled")
        if "one block" in label:
            check(int(got[2][0, 7]) == 300 and int(got[2][1, 3_999]) > 0
                  and not bool(got[2][1, 4_000:].any()),
                  f"csr_quant {label}: block counts misplaced")
    shapes = []
    for v, i, s in ((v6, i6, s6), (v1, i1, s1)):
        sh = {"shape": list(v.shape), "n": N_FULL, **csr_quant_call(
            torch, ops, v, i, s, N_FULL, "int8", flushes),
            "plain_ms": time_ms(torch, lambda: _quant_plain(
                ref, v, i, s, N_FULL, "int8"), reps=10,
                flush=flushes.clean),
            "library_ms": None}
        log(f"  csr_quant {sh['shape']}: device {sh['device_ms']:.5f} ms in "
            f"{sh['device_ops']:g} ops, host {sh['host_ms']:.5f} ms, bound "
            f"{sh['bound_ms']:.5f} ms ({sh['bound_ms'] / sh['device_ms']:.0%}"
            f" of it)")
        check(sh["device_ops"] == 1, f"csr_quant {sh['shape']}: "
              f"{sh['device_ops']} device ops a call, not 1")
        shapes.append(sh)
    return {"name": "csr_quant", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/csr_quant.cu",
            "replaces": "src/repro/kernels/csr_quant.py:62",
            "max_abs_err": 0.0, **shapes[0], "other_shapes": shapes[1:]}


# the slice's chunked layout of the paper CNN: 9 leaf-aligned chunks of
# widths 99,072 (conv, keep 0.5), 256, 5 x 1,000,000, 111,808 and 2,313
# (out, keep 0.5)
CHUNK = {"chunk_size": 1_000_000, "layer_keep_frac": {"conv": 0.5,
                                                      "out": 0.5}}
CHUNK_TIMED = (99_072, 1_000_000, 2_313)


def chunk_plan(port, comm_mod):
    """The slice layout's per-chunk plan (``SparseComm.chunk_plan``)."""
    layout = port.ParamLayout.from_template(
        port.cnn_template(port.CNNConfig()), CHUNK["chunk_size"],
        overrides=CHUNK["layer_keep_frac"])
    return comm_mod.SparseComm("p0.2", layout=layout).chunk_plan()


def _chunk_inputs(torch, ref, comm_mod, gen, dev, p, k):
    """One chunk's kernel inputs at ``k`` rows: update-sized deltas, their
    thresholds at the chunk's keep fraction, the payload's residual (what
    the capped payload leaves) and its thresholds, and (k, nc) weights."""
    x = _delta(torch, gen, dev, k, p["nc"])
    thr = comm_mod.local_quantile_thresholds(x, p["keep"] or 0.2)
    res = (x - ref.csr_capped_mask_ref(x, thr, p["cap"])[0]).contiguous()
    w = torch.rand((k,), generator=gen, device=dev)
    return SimpleNamespace(x=x, thr=thr, res=res, w=w / w.sum(),
                           rthr=comm_mod.local_quantile_thresholds(
                               res, p["rfrac"]))


def _chunk_calls(torch, ops, ref, p, inp, what):
    """The kernel calls a chunk's round makes on ``inp``, each paired with
    its plain version on the same inputs: ``what`` "upload" (compact at
    cap, quantize int8 and fp16, the blend's staleness_agg), "residual"
    (compact at rcap) or "chain" (compact, quantize). Returns [(label,
    kernel call, plain call)]; a quantize takes its compact's kernel
    output, so a call list runs in order."""
    nc, cap = p["nc"], p["cap"]
    k = inp.x.shape[0]
    tag = f"({k}, {nc})"
    if what == "residual":
        return [(f"csr_compact residual {tag} rcap {p['rcap']}",
                 lambda: ops.csr_compact(inp.res, inp.rthr, p["rcap"]),
                 lambda: ref.csr_compact2d_ref(inp.res, inp.rthr,
                                               p["rcap"]))]
    out = {}

    def compact():
        out["c"] = ops.csr_compact(inp.x, inp.thr, cap)
        return out["c"]

    def quant(q_dtype):
        def kern():
            v, i, nnz = out["c"]
            return ops.csr_quantize(v, i, torch.clamp(nnz, max=cap), nc,
                                    q_dtype=q_dtype)

        def plain():
            v, i, nnz = out["c"]
            return _quant_plain(ref, v, i, torch.clamp(nnz, max=cap), nc,
                                q_dtype)
        return kern, plain

    calls = [(f"csr_compact {what} {tag} cap {cap}", compact,
              lambda: ref.csr_compact2d_ref(inp.x, inp.thr, cap))]
    for q_dtype in (("int8", "fp16") if what == "upload" else ("int8",)):
        calls.append((f"csr_quant {q_dtype} {what} {tag}", *quant(q_dtype)))
    if what == "upload":
        calls.append((f"staleness_agg {tag}",
                      lambda: ops.staleness_agg(inp.x, inp.w),
                      lambda: ref.staleness_agg_ref(inp.x, inp.w)))
    return calls


def _hold(torch, calls):
    """Launch every kernel call in order with no synchronisation between
    them, then hold each result against its plain version bit for bit."""
    got = [(label, kern()) for label, kern, _ in calls]
    torch.cuda.synchronize()
    for (label, out), (_, _, plain) in zip(got, calls):
        want = plain()
        out = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        same = [_same_bits(torch, a, b) for a, b in zip(out, want)]
        check(len(out) == len(want) and all(same),
              f"{label}: kernel differs from plain ({same})")
    return len(calls)


def check_chunk_widths(torch, ops, ref, comm_mod, port, dev, gen, flushes):
    """``csr_compact``, ``csr_quant`` (int8, fp16) and ``staleness_agg`` bit
    for bit at every distinct chunk width of the slice layout at K = 6 and
    K = 1 with the plan's caps and rcaps; then all nine chunks' calls of
    one csr_q + EF round back to back on one stream (upload, residual,
    chain per chunk), so the kernels' per-stream workspaces see every
    shape change; then one call of each kernel at three widths timed
    under the read-only flush. Returns {kernel: [timed shape entries]}."""
    plan = chunk_plan(port, comm_mod)
    widths = {}
    for p in plan:
        widths.setdefault(p["nc"], p)
    held = 0
    for nc, p in widths.items():
        for k in (6, 1):
            inp = _chunk_inputs(torch, ref, comm_mod, gen, dev, p, k)
            for what in ("upload", "residual"):
                held += _hold(torch, _chunk_calls(torch, ops, ref, p, inp,
                                                  what))
    log(f"  chunk widths {sorted(widths)} at K = 6 and 1: {held} calls "
        "bit-exact")
    seq = []
    for p in plan:
        up = _chunk_inputs(torch, ref, comm_mod, gen, dev, p, 6)
        chain = _chunk_inputs(torch, ref, comm_mod, gen, dev, p, 1)
        seq += _chunk_calls(torch, ops, ref, p, up, "upload") + \
            _chunk_calls(torch, ops, ref, p, up, "residual") + \
            _chunk_calls(torch, ops, ref, p, chain, "chain")
    n = _hold(torch, seq)
    log(f"  the {len(plan)} chunks' calls back to back on one stream: {n} "
        "calls bit-exact")
    timed = {"csr_compact": [], "csr_quant": [], "staleness_agg": []}
    for nc in CHUNK_TIMED:
        p = widths[nc]
        inp = _chunk_inputs(torch, ref, comm_mod, gen, dev, p, 6)
        x, thr, cap = inp.x, inp.thr, p["cap"]
        timed["csr_compact"].append({
            "shape": [6, nc], "case": "chunk upload", "cap": cap,
            **csr_compact_call(torch, ops, x, thr, cap, flushes),
            "plain_ms": time_ms(torch, lambda: ref.csr_compact2d_ref(
                x, thr, cap), reps=10, flush=flushes.clean),
            "library_ms": None})
        v, i, nnz = ops.csr_compact(x, thr, cap)
        st = torch.clamp(nnz, max=cap)
        timed["csr_quant"].append({
            "shape": [6, cap], "n": nc, "case": "chunk upload",
            **csr_quant_call(torch, ops, v, i, st, nc, "int8", flushes),
            "plain_ms": time_ms(torch, lambda: _quant_plain(
                ref, v, i, st, nc, "int8"), reps=10, flush=flushes.clean),
            "library_ms": None})
        w = inp.w
        timed["staleness_agg"].append({
            "shape": [6, nc], "case": "chunk blend", **_timed(
                torch, lambda: ops.staleness_agg(x, w),
                lambda: ref.staleness_agg_ref(x, w), 7 * 4 * nc + 4 * 6,
                2 * 6 * nc, reps=30, flushes=flushes,
                library=lambda: w @ x)})
    for name, shapes in timed.items():
        for sh in shapes:
            log(f"  {name} chunk {sh['shape']}: kernel {sh['ms']:.5f} ms "
                f"(events {sh['event_ms']:.5f}), plain {sh['plain_ms']:.5f} "
                f"ms, library {sh['library_ms']}, bound "
                f"{sh['bound_ms']:.6f} ms ({sh['bound_by']}), "
                f"{sh['bound_ms'] / sh['ms']:.0%} of it")
    return timed


# the participant counts a faulted round can have besides the 6 and 1 held
# above: a degraded quorum, down to the floor (phase 5f)
FAULT_KS = (2, 3, 4, 5)
# the dense store's distribution rows (phase 5g): one target at a time on
# the sequential engine, and on the batched one the T targets of a round,
# its participants and tau-forced clients, from K = 6 up to M = 10
DIST_KS = (1, 6, 7, 8, 9, 10)


def check_every_k(torch, ops, ref, comm_mod, port, dev, gen, ks=FAULT_KS,
                  chunks=True):
    """The four FL compaction kernels bit for bit at every row count ``ks``
    that a faulted round (``FAULT_KS``, beyond the 6 and 1 held above) or a
    dense-store distribution (``DIST_KS``) gives them: at (K, N) the upload
    (``csr_compact`` at cap, ``csr_quant`` int8 and fp16, ``staleness_agg``)
    and ``sparse_delta`` (its top-20% form and explicit thresholds), with
    ``chunks`` also the EF residual (``csr_compact`` at rcap) and at every
    chunk width of the slice layout the chunked round's calls (upload,
    residual, chain); each K's calls back to back on one stream, so the
    per-stream workspaces see K change between calls. Returns the number
    of calls held."""
    flat = {"nc": N_FULL, "cap": CAP_FULL, "rcap": RCAP_FULL, "keep": 0.2,
            "rfrac": 0.25}
    widths = {}
    if chunks:
        for p in chunk_plan(port, comm_mod):
            widths.setdefault(p["nc"], p)
    held = 0
    for k in ks:
        inp = _chunk_inputs(torch, ref, comm_mod, gen, dev, flat, k)
        calls = _chunk_calls(torch, ops, ref, flat, inp, "upload")
        if chunks:
            calls += _chunk_calls(torch, ops, ref, flat, inp, "residual")
        top = {}

        def topfrac(x=inp.x):
            m, n, top["t"] = ops.sparse_delta_topfrac(x, 0.2)
            return m, n

        calls += [(f"sparse_delta top 20% ({k}, N)", topfrac,
                   lambda x=inp.x: ref.sparse_delta2d_ref(x, top["t"])),
                  (f"sparse_delta ({k}, N)",
                   lambda x=inp.x, t=inp.thr: ops.sparse_delta_batch(x, t),
                   lambda x=inp.x, t=inp.thr: ref.sparse_delta2d_ref(x, t))]
        for p in widths.values():
            c = _chunk_inputs(torch, ref, comm_mod, gen, dev, p, k)
            calls += _chunk_calls(torch, ops, ref, p, c, "upload") + \
                _chunk_calls(torch, ops, ref, p, c, "residual") + \
                _chunk_calls(torch, ops, ref, p, c, "chain")
        held += _hold(torch, calls)
        del inp, calls
    log(f"  K = {list(ks)} at (K, N) and the chunk widths "
        f"{sorted(widths)}: {held} calls bit-exact")
    return held


def _bf16_ulps_apart(torch, a, b, atol=0.0):
    """Largest distance of ``a`` from ``b`` (bf16 tensors), less ``atol``,
    in units of one bf16 ulp at the larger magnitude of each pair."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)       # 8 significant bits
    return float(((a - b).abs() - atol).clamp(min=0.0).div(ulp).max())


def _attention_work(B, S, Hq, Hkv, hd, elem, window):
    """(bytes, flops) of one attention call: q, k, v read once and out
    written once; 4 hd flops (q.k and p.v) for each visible (query, key)
    pair, which the causal mask and the window decide."""
    pairs = sum(min(qp + 1, window or qp + 1) for qp in range(S))
    return elem * B * S * (2 * Hq + 2 * Hkv) * hd, 4 * B * Hq * hd * pairs


def flash_build_report(build, out_dir):
    """The bf16 tensor-core instances' ptxas report (registers, spills)
    from this process's build log, and the count of HGMMA (wgmma)
    instructions in the built ``flash_attention.so``; fails if there are
    none, which would mean the bf16 path lost its tensor cores."""
    instances, name = {}, None
    for line in build.build_log.get("flash_attention", "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "flash_attention_wgmma" in line \
                else None
            if name:
                instances[name] = {"hd": 128 if "ILi128E" in name else 64}
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            instances[name].update(stack_bytes=nums[0],
                                   spill_store_bytes=nums[1],
                                   spill_load_bytes=nums[2])
        elif name and "Used" in line and "registers" in line:
            instances[name]["registers"] = int(
                line.split("Used")[1].split()[0])
    cuobjdump = Path(build._nvcc()).resolve().with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(out_dir / "flash_attention.so")],
                          capture_output=True, text=True, check=True).stdout
    hgmma = sum(1 for line in sass.splitlines() if "HGMMA" in line)
    for rep in instances.values():
        log(f"  flash_attention bf16 (wgmma): {rep}")
    if not instances:
        log("  flash_attention: built before this process, no ptxas report")
    log(f"  flash_attention.so: {hgmma} HGMMA instructions")
    check(hgmma > 0, "flash_attention.so holds no HGMMA instruction: the "
          "bf16 path does not run on the tensor cores")
    return {"hgmma": hgmma, "ptxas_bf16": list(instances.values())}


def check_flash_attention(torch, ops, ref, dev, gen, s_serve):
    """The CUDA flash kernel against ``flash_attention_plain`` on the card:
    float32 (the FFMA kernel) to atol / rtol 2e-5 (the reference's own
    tolerance); bf16 (the wgmma kernel) at most one bf16 ulp apart beyond
    that float32 atol: the two compute in float32 and sum in other orders,
    so an output can round to the neighbouring bf16 value, and an output
    near zero (a sum that cancels) carries a float32 rounding error of
    ~1e-7, which spans many bf16 ulps of its own magnitude (the raw
    distance in ulps is printed too). Shapes, each in both dtypes: the
    serve prefill's (8, S, 12 / 2 heads, hd 128), ragged lengths (S = 1,
    127, 1000), a window, the reduced config's hd 64 with 4 / 2 heads, one
    KV head per query head, and a non-causal call."""
    import torch.nn.functional as F
    cases = [  # (label, B, S, Hq, Hkv, hd, dtype, window, causal)
        ("serve prefill bf16", 8, s_serve, 12, 2, 128, torch.bfloat16, None,
         True),
        ("serve prefill f32", 8, s_serve, 12, 2, 128, torch.float32, None,
         True),
        ("ragged S = 1", 2, 1, 12, 2, 128, torch.float32, None, True),
        ("ragged S = 1 bf16", 2, 1, 12, 2, 128, torch.bfloat16, None, True),
        ("ragged S = 127", 2, 127, 12, 2, 128, torch.float32, None, True),
        ("ragged S = 127 bf16", 2, 127, 12, 2, 128, torch.bfloat16, None,
         True),
        ("ragged S = 1000", 2, 1000, 12, 2, 128, torch.bfloat16, None, True),
        ("ragged S = 1000 f32", 2, 1000, 12, 2, 128, torch.float32, None,
         True),
        ("window 96, S = 384", 2, 384, 12, 2, 128, torch.float32, 96, True),
        ("window 96, S = 384 bf16", 2, 384, 12, 2, 128, torch.bfloat16, 96,
         True),
        ("reduced hd 64, 4 / 2 heads", 2, 256, 4, 2, 64, torch.bfloat16,
         None, True),
        ("reduced hd 64 f32", 2, 256, 4, 2, 64, torch.float32, None, True),
        ("G = 1", 2, 256, 4, 4, 128, torch.float32, None, True),
        ("G = 1 bf16", 2, 256, 4, 4, 128, torch.bfloat16, None, True),
        ("non-causal S = 1000", 1, 1000, 4, 2, 128, torch.float32, None,
         False),
        ("non-causal S = 1000 bf16", 1, 1000, 4, 2, 128, torch.bfloat16,
         None, False),
    ]
    worst, tensors = 0.0, {}
    for label, B, S, Hq, Hkv, hd, dt, window, causal in cases:
        q = torch.randn((B, S, Hq, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dt)
        got = ops.flash_attention(q, k, v, window=window, causal=causal)
        want = ref.flash_attention_plain(q, k, v, window=window,
                                         causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        if dt == torch.float32:
            ok = torch.allclose(got, want, atol=2e-5, rtol=2e-5)
            log(f"  flash_attention {label}: ({B}, {S}, {Hq}/{Hkv}, {hd}), "
                f"max |kernel - plain| = {err:.3g}, allclose 2e-5: {ok}")
        else:
            ulps = _bf16_ulps_apart(torch, got, want, atol=2e-5)
            ok = ulps <= 1.0
            log(f"  flash_attention {label}: ({B}, {S}, {Hq}/{Hkv}, {hd}), "
                f"max |kernel - plain| = {err:.3g}, {ulps:.3g} bf16 ulp "
                f"beyond atol 2e-5 ({_bf16_ulps_apart(torch, got, want):.3g}"
                f" without)")
        check(ok and bool(torch.isfinite(got).all()),
              f"flash_attention {label}: kernel differs from plain")
        if label.startswith(("serve", "reduced hd 64,")):
            tensors[label] = (q, k, v)
    shapes = []
    for label, (q, k, v) in tensors.items():
        B, S, Hq, hd = q.shape
        Hkv = k.shape[2]
        bf16 = q.dtype == torch.bfloat16
        nbytes, flops = _attention_work(B, S, Hq, Hkv, hd, q.element_size(),
                                        None)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        reps = 5 if S > 1024 else 20
        shape = {"shape": [B, S, Hq, Hkv, hd], "dtype": str(q.dtype),
                 "bytes": nbytes, "flops": flops, **_timed(
            torch, lambda: ops.flash_attention(q, k, v),
            lambda: ref.flash_attention_plain(q, k, v), nbytes, flops,
            reps=reps, library=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
                 **profile_call(torch, lambda: ops.flash_attention(q, k, v),
                                reps=reps)}
        if bf16:   # the bound at the type's rate; beside it the float32 rule
            shape["bound_ms"], shape["bound_by"] = bound_ms(
                nbytes, flops, BF16_OPS_PER_S)
            shape["bound_f32_ms"] = bound_ms(nbytes, flops)[0]
        shapes.append(shape)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:65",
            "max_abs_err": worst, **shapes[0], "other_shapes": shapes[1:]}


# -- phase 4: the trainer on the card against itself on the CPU -----------
def _param_diff(np, a, b):
    """(max |a - b|, elements outside atol 1e-4 + rtol 1e-3 of b, total)."""
    worst, outside, total = 0.0, 0, 0
    for name in sorted(a):
        diff = np.abs(a[name] - b[name])
        worst = max(worst, float(diff.max()))
        outside += int((diff > 1e-4 + 1e-3 * np.abs(b[name])).sum())
        total += diff.size
    return worst, outside, total


def _tap_messages(comm):
    """Wrap ``comm``'s per-message threshold rule so that each message's
    thresholds and ``|delta|`` are kept on the host, in message order."""
    rule, seen = comm._row_thresholds, []

    def tapped(delta, **kw):
        thr = rule(delta, **kw)
        seen.append((thr.cpu(), delta.abs().cpu()))
        return thr

    comm._row_thresholds = tapped
    return seen


def _trainer_run(torch, port, cnn, init, dev, rounds, threshold="p0.2",
                 engine="sequential", **extra):
    data = port.make_dataset("basic", scale=0.005, seed=0)
    t0 = time.perf_counter()
    tr = port.FedS3ATrainer(
        data, port.FedS3AConfig(rounds=rounds, cnn=cnn, device=dev,
                                sparse_threshold=threshold, engine=engine,
                                **extra),
        init_params=init)
    warm = port.params_to_numpy(tr.global_params)
    seen = _tap_messages(tr.comm)
    out = tr.train()
    log(f"  {dev}, {engine}, threshold {threshold} {extra or ''}: "
        f"{time.perf_counter() - t0:.2f} s, accuracy "
        f"{out['metrics']['accuracy']:.6f}, ACO {out['aco']:.6f}")
    return SimpleNamespace(tr=tr, warm=warm, out=out, seen=seen,
                           params=port.params_to_numpy(tr.global_params))


def _first_flips(torch, a, b):
    """The first message whose kept set differs between runs ``a`` and
    ``b``: (message, flipped elements, thresholds equal, largest relative
    distance of a flipped |delta| from its threshold on either run, card
    elements within that distance), or None."""
    for m, ((ta, da), (tb, db)) in enumerate(zip(a.seen, b.seen)):
        ka = (da >= ta[:, None]) & (da != 0)
        kb = (db >= tb[:, None]) & (db != 0)
        flips = ka ^ kb
        if bool(flips.any()):
            ra = ((da - ta[:, None]).abs() / ta[:, None])
            rb = ((db - tb[:, None]).abs() / tb[:, None])
            dist = float(torch.maximum(ra[flips], rb[flips]).max())
            return (m, int(flips.sum()), bool(torch.equal(ta, tb)), dist,
                    int((ra <= dist).sum()))
    return None


def _same_schedules(a, b, what):
    for la, lb in zip(a.tr.logs, b.tr.logs, strict=True):
        check((la.participants, la.stalenesses, la.forced, la.time)
              == (lb.participants, lb.stalenesses, lb.forced, lb.time),
              f"{what}: schedules differ at round {la.round}")


def _cross_criteria(np, a, b, what):
    """The reference's cross-engine criteria plus max |diff| <= 1e-3."""
    _same_schedules(a, b, what)
    worst, outside, total = _param_diff(np, a.params, b.params)
    mdiff = max(abs(a.out["metrics"][k] - b.out["metrics"][k])
                for k in a.out["metrics"])
    adiff = abs(a.out["aco"] - b.out["aco"])
    log(f"  {what}: max |diff| {worst:.3g} ({outside} of {total} outside "
        f"atol 1e-4 + rtol 1e-3), max |metric diff| {mdiff:.3g}, |ACO "
        f"diff| {adiff:.3g}")
    check(worst <= 1e-3, f"{what}: parameters differ by {worst}")
    check(mdiff < 1e-4, f"{what}: metrics differ by {mdiff}")
    check(adiff < 2e-3, f"{what}: ACO differs by {adiff}")


def _witness(np, a, b, what):
    """Elementwise atol 1e-4 / rtol 1e-3 with the absolute threshold."""
    _same_schedules(a, b, what)
    worst, outside, total = _param_diff(np, a.params, b.params)
    log(f"  {what}, absolute threshold 1e-6: max |diff| {worst:.3g} "
        f"({outside} of {total} outside atol 1e-4 + rtol 1e-3), |ACO diff| "
        f"{abs(a.out['aco'] - b.out['aco']):.3g}")
    check(outside == 0, f"{what}: with an absolute threshold parameters "
          "differ past atol 1e-4 + rtol 1e-3")


def trainer_gpu_vs_cpu(torch, port, rounds=2):
    """The sequential engine on the card twice and on the CPU once from the
    same initial weights, then card and CPU once more with an absolute
    threshold.

    Before any sparsified message (after the server warm-up) the card and
    the CPU must agree to atol 1e-4 / rtol 1e-3. After the rounds on the
    paper's p0.2 wire they are held to the reference's own cross-engine
    criteria: identical schedules, metrics within 1e-4, ACO within 2e-3,
    and every parameter within 1e-3, not elementwise. Adam's first steps
    put a large share of the delta magnitudes within rounding of each
    other, the sampled quantile lands in that cluster, and an element
    whose |delta| rounds differently on the two devices is kept on one and
    dropped on the other; the first such message is reported. The
    elementwise atol 1e-4 / rtol 1e-3 is held by the witness: with an
    absolute threshold two decades below the update size no cluster sits
    at the threshold, and card and CPU must agree on every element. Two
    runs on the card must be bit-identical."""
    import numpy as np
    cnn = port.CNNConfig(dropout=0.0)
    gen = torch.Generator().manual_seed(0)
    init = port.params_to_numpy(port.init_cnn(cnn, gen))
    g, g2, c = (_trainer_run(torch, port, cnn, init, dev, rounds)
                for dev in ("cuda", "cuda", "cpu"))
    check(all(np.array_equal(g.params[k], g2.params[k]) for k in g.params)
          and g.out["aco"] == g2.out["aco"], "two runs on the card differ")
    worst, outside, total = _param_diff(np, g.warm, c.warm)
    log(f"  after the warm-up: max |card - CPU| {worst:.3g}, {outside} of "
        f"{total} outside atol 1e-4 + rtol 1e-3")
    check(outside == 0, "card and CPU differ after the warm-up")
    _cross_criteria(np, g, c, f"card vs CPU after {rounds} rounds")
    first = _first_flips(torch, g, c)
    if first is not None:
        m, n_flip, same_thr, dist, near = first
        log(f"  first message whose kept set differs: {m} of "
            f"{len(g.seen)}, thresholds equal on both: {same_thr}; "
            f"{n_flip} elements flip, each within {dist:.3g} (relative) "
            f"of the threshold, where the card has {near} elements")
    del g2
    ga, ca = (_trainer_run(torch, port, cnn, init, dev, rounds,
                           threshold=1e-6) for dev in ("cuda", "cpu"))
    _witness(np, ga, ca, "card vs CPU")


def chunked_gpu_vs_cpu(torch, port, rounds=2):
    """The chunked trainer (the slice layout: 9 chunks, conv and out kept
    at 0.5) on the card against the CPU from the same initial weights,
    sequential engine (the stacked round body), full width, dropout 0:
    the cross-engine criteria plus max |diff| <= 1e-3."""
    import numpy as np
    cnn = port.CNNConfig(dropout=0.0)
    gen = torch.Generator().manual_seed(3)
    init = port.params_to_numpy(port.init_cnn(cnn, gen))
    g, c = (_trainer_run(torch, port, cnn, init, dev, rounds, **CHUNK)
            for dev in ("cuda", "cpu"))
    check(g.tr.chunked and g.tr.layout.num_chunks == 9,
          f"chunked run has layout {g.tr.layout}")
    _cross_criteria(np, g, c, f"chunked card vs CPU after {rounds} rounds")
    worst, outside, _ = _param_diff(np, g.params, c.params)
    return {"max_diff": worst, "outside_atol_rtol": outside,
            "aco": [g.out["aco"], c.out["aco"]],
            "accuracy": [g.out["metrics"]["accuracy"],
                         c.out["metrics"]["accuracy"]]}


def engines_on_card(torch, port, rounds=2):
    """The batched engine against the sequential one, both on the card,
    from the same initial weights with the paper's dropout 0.1: both draw
    each participant's masks from the same per-round seeds, so they differ
    only in the order of the products' sums. Held to the same criteria as
    card against CPU: on the p0.2 wire the reference's cross-engine ones
    plus max |diff| <= 1e-3, and elementwise with the absolute threshold;
    then the csr_q wire with error feedback on the cross-engine criteria
    (a sum in another order can move a value across a rounding boundary
    of the int8 grid, one quantum of that row's scale)."""
    import numpy as np
    cnn = port.CNNConfig()
    gen = torch.Generator().manual_seed(1)
    init = port.params_to_numpy(port.init_cnn(cnn, gen))
    for threshold, extra in (("p0.2", {}), (1e-6, {}),
                             ("p0.2", {"wire_format": "csr_q",
                                       "error_feedback": True})):
        s, b = (_trainer_run(torch, port, cnn, init, "cuda", rounds,
                             threshold=threshold, engine=engine, **extra)
                for engine in ("sequential", "batched"))
        if threshold == "p0.2":
            _cross_criteria(np, b, s, f"batched vs sequential after "
                            f"{rounds} rounds {extra or ''}")
        else:
            _witness(np, b, s, "batched vs sequential")


# -- phase 5: the six paths ------------------------------------------------
# (engine, wire, error feedback) -> the kernels that path must launch; every
# other kernel must not launch on it
CSR_KERNELS = ("masked_pseudo_ce", "masked_pseudo_ce_bwd", "csr_compact",
               "staleness_agg")
DENSE_KERNELS = ("masked_pseudo_ce", "masked_pseudo_ce_bwd", "sparse_delta",
                 "staleness_agg")
PATHS = {
    ("sequential", "csr", False): CSR_KERNELS,
    ("batched", "csr", False): CSR_KERNELS,
    ("batched", "dense_masked", False): DENSE_KERNELS,
    ("sequential", "dense_masked", False): DENSE_KERNELS,
    ("batched", "csr_q", True): CSR_KERNELS + ("csr_quant",),
    ("sequential", "csr_q", True): CSR_KERNELS + ("csr_quant",),
}
DEFAULT_PATH = ("batched", "csr", False)
# launches a round that a path must show exactly, a number or a function of
# the round's K participants: the batched round compacts the upload stack
# and the chain advance, and with EF the residuals too, and quantizes the
# upload stack and the chain, whatever K; the sequential round does each
# per participant (K + 1 compactions, with EF 2K + 1)
PER_ROUND = {
    ("sequential", "csr", False): {"csr_compact": lambda k: k + 1},
    ("batched", "csr", False): {"csr_compact": 2},
    ("batched", "csr_q", True): {"csr_quant": 2, "csr_compact": 3},
    ("sequential", "csr_q", True): {"csr_quant": lambda k: k + 1,
                                    "csr_compact": lambda k: 2 * k + 1},
}


# phase 5's paged paths, each right after its resident twin; the dense_masked
# one needs a resident twin with EF, which the six paths do not have
PAGED_PATHS = (("sequential", "csr_q", True), ("batched", "csr_q", True),
               ("batched", "dense_masked", True))
PATH_KERNELS = {**PATHS, ("batched", "dense_masked", True): DENSE_KERNELS}
# phase 5's chunked paths under the slice layout (``CHUNK``), (engine,
# wire, EF, store): both engines run the stacked round body, whose every
# encode stage goes chunk by chunk, so each stage's launches are the flat
# batched round's times the 9 chunks (upload, chain and with EF the
# residuals compacted, upload and chain quantized, the blend's base sum)
CHUNK_PATHS = (("batched", "csr", False, "resident"),
               ("batched", "csr_q", True, "resident"),
               ("sequential", "csr_q", True, "resident"),
               ("batched", "csr_q", True, "paged"))
CHUNK_PER_ROUND = {
    ("csr", False): {"csr_compact": 18, "staleness_agg": 9},
    ("csr_q", True): {"csr_compact": 27, "csr_quant": 18,
                      "staleness_agg": 9}}
FLAT_CHUNK_SIZE = 6_000_000     # >= N: resolves to the flat path


def chunk_launches(kernel, sh, paths):
    """The launches of ``kernel`` at a timed chunk shape's width on each
    chunked phase-5 path, counted by the wrapper in that path's run and
    split by the call's rows: {path: {"rows x width": launches}}."""
    width = sh.get("n", sh["shape"][1])
    return {p: {f"{rows}x{w}": c for name, rows, w, c in
                r["launches_by_shape"] if name == kernel and w == width}
            for p, r in paths.items() if r.get("chunk_stored_share")}


def path_name(engine, wire, ef, store="resident", chunk=None):
    return f"{engine}+{wire}" + ("+ef" if ef else "") + \
        ("+paged" if store == "paged" else "") + \
        ("" if not chunk else "+chunked" if chunk == CHUNK else
         f"+chunk_size={chunk['chunk_size']}")


def params_digest(port, tr):
    """SHA-256 of the global parameters' bytes, in name order."""
    return tree_digest(port, tr.global_params)


def tree_digest(port, tree):
    """``params_digest`` of a {name: tensor} parameter tree."""
    h = hashlib.sha256()
    for name, v in sorted(port.params_to_numpy(tree).items()):
        h.update(name.encode())
        h.update(v.tobytes())
    return h.hexdigest()


def check_launches(launches, kernels, name, per_round=None, ks=(None,)):
    """Every kernel of the path launched, none off it, the
    ``masked_pseudo_ce`` backward once a forward, and the exact counts of
    ``per_round`` (a number a round, or a function of the round's K) summed
    over the run's rounds, whose participant counts ``ks`` lists."""
    for kernel, count in launches.items():
        if kernel in kernels:
            check(count > 0, f"kernel {kernel} never launched on {name}")
        else:
            check(count == 0, f"kernel {kernel} launched {count} times off "
                  f"its path ({name})")
    check(launches["masked_pseudo_ce_bwd"] == launches["masked_pseudo_ce"],
          f"{name}: {launches['masked_pseudo_ce_bwd']} backward launches "
          f"for {launches['masked_pseudo_ce']} forward ones")
    for kernel, count in (per_round or {}).items():
        want = sum(count(k) if callable(count) else count for k in ks)
        check(launches[kernel] == want,
              f"{kernel} launched {launches[kernel]} times on {name}, "
              f"expected {want} over rounds of K = {list(ks)}")


def store_seconds(tr):
    """Host seconds the paged store spent in the run (its own ``seconds``:
    ``drain_s`` draining its write queue, waits for the device-to-host
    copies included, ``window_s`` gathering windows and enqueuing their
    copies); None for the resident store."""
    if not tr.paged:
        return None
    return dict(tr.cstore.seconds)


def drive_path(torch, port, ops, engine, wire, ef, rounds=3,
               store="resident", chunk=None):
    import numpy as np
    data = port.make_dataset("basic", scale=0.02)
    cfg = port.FedS3AConfig(rounds=rounds, wire_format=wire,
                            error_feedback=ef, client_store=store,
                            **(chunk or {}))
    if (engine, wire, ef) != DEFAULT_PATH:
        cfg.engine = engine
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = port.FedS3ATrainer(data, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = tr.train()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    store_s = store_seconds(tr)
    launches = dict(ops.LAUNCHES)
    by_shape = sorted([*key, c] for key, c in ops.LAUNCHES_BY_SHAPE.items())
    peak = torch.cuda.max_memory_allocated()
    name = path_name(engine, wire, ef, store, chunk)
    check(tr.engine == engine, f"{name} ran {tr.engine}")
    check(tr.chunked == (chunk == CHUNK) and (not tr.chunked or
                                              tr.layout.num_chunks == 9),
          f"{name} ran layout {tr.layout}")
    n = port.cnn_param_count(tr.cnn)
    check(n == N_FULL, f"paper CNN has {n} parameters, expected {N_FULL}")
    params = port.params_to_numpy(tr.global_params)
    check(all(np.isfinite(v).all() for v in params.values()),
          "non-finite global parameters")
    check(out["rounds"] == rounds and len(tr.logs) == rounds,
          "wrong number of rounds")
    m = out["metrics"]
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()),
          f"metrics out of range: {m}")
    check(0.0 < out["aco"] < 1.0, f"ACO out of range: {out['aco']}")
    s_round = (t2 - t1) / rounds
    state = tr.client_state_device_bytes()
    log(f"  {name}: {rounds} rounds, N = {n}: set-up (warm-up) "
        f"{t1 - t0:.3f} s, {s_round:.3f} s per round, accuracy "
        f"{m['accuracy']:.6f}, ACO {out['aco']:.6f}; client state on the "
        f"device {state} B, peak device memory {peak} B; "
        + ("" if store_s is None else
           f"paged store host s a round: drain "
           f"{store_s['drain_s'] / rounds:.4f}, windows "
           f"{store_s['window_s'] / rounds:.4f}; ")
        + f"launches {launches}")
    share = tr.comm.chunk_stored_share() if tr.chunked else None
    if share is not None:
        log(f"  {name}: stored share a chunk (keep "
            f"{[p['keep'] for p in tr.comm.chunk_plan()]}): uploads "
            f"{[round(x, 6) for x in share['upload']]}, chain "
            f"{[round(x, 6) for x in share['chain']]}")
    per_round = CHUNK_PER_ROUND[(wire, ef)] if tr.chunked else \
        PER_ROUND.get((engine, wire, ef))
    check_launches(launches, PATH_KERNELS[(engine, wire, ef)], name,
                   per_round, [len(log.participants) for log in tr.logs])
    return tr, launches, {"s_per_round": s_round, "setup_s": t1 - t0,
                          "accuracy": m["accuracy"], "aco": out["aco"],
                          "client_state_device_bytes": state,
                          "peak_device_bytes": peak,
                          "peak_delta_device_bytes":
                          tr.peak_delta_device_bytes(),
                          "store_host_s": store_s,
                          "digest": params_digest(port, tr),
                          "participants": [len(log.participants)
                                           for log in tr.logs],
                          "launches_by_shape": by_shape,
                          "chunk_stored_share": share}


def paged_twins(torch, port, ops, engine, wire, ef):
    """The path resident, then paged, in one process: the paged run must
    be its twin's bit for bit (accuracy, ACO, participants a round, the
    global parameters' bytes), with the same launch rules."""
    out = {}
    for store in ("resident", "paged"):
        tr, launches, res = drive_path(torch, port, ops, engine, wire, ef,
                                       store=store)
        res["launches"] = launches
        out[store] = res
        del tr
        torch.cuda.empty_cache()
    a, b = out["resident"], out["paged"]
    name = path_name(engine, wire, ef, "paged")
    same = {k: a[k] == b[k] for k in ("accuracy", "aco", "participants",
                                      "digest", "launches")}
    log(f"  {name} against its resident twin: {same}")
    check(all(same.values()), f"{name} differs from its resident twin: "
          f"{same}")
    return out


SAME_KEYS = ("accuracy", "aco", "participants", "digest")


def chunked_paths(torch, port, ops, flat_csr):
    """Phase 5's chunked paths (``CHUNK_PATHS``), each driven like the flat
    ones with exact launches a round (``CHUNK_PER_ROUND``) and one more
    round of batched csr_q + EF profiled: the sequential engine's run
    must be the batched one's bit for bit (digest, accuracy, ACO,
    participants), the paged run its resident twin's, and a chunk size
    of N or more (``FLAT_CHUNK_SIZE``) must resolve to no layout and give
    the flat batched + csr run ``flat_csr`` bit for bit."""
    out = {}
    for engine, wire, ef, store in CHUNK_PATHS:
        tr, launches, res = drive_path(torch, port, ops, engine, wire, ef,
                                       store=store, chunk=CHUNK)
        res["launches"] = launches
        if (engine, wire, ef, store) == ("batched", "csr_q", True,
                                         "resident"):
            res["profiled_round"] = profile_round(torch, tr.run_round)
        out[path_name(engine, wire, ef, store, CHUNK)] = res
        del tr
        torch.cuda.empty_cache()
    b = out["batched+csr_q+ef+chunked"]
    for other in ("sequential+csr_q+ef+chunked",
                  "batched+csr_q+ef+paged+chunked"):
        same = {k: out[other][k] == b[k] for k in SAME_KEYS}
        log(f"  {other} against batched+csr_q+ef+chunked: {same}")
        check(all(same.values()), f"{other} differs: {same}")
    chunk = {"chunk_size": FLAT_CHUNK_SIZE}
    tr, launches, res = drive_path(torch, port, ops, "batched", "csr",
                                   False, chunk=chunk)
    check(tr.layout is None and not tr.chunked,
          f"chunk_size {FLAT_CHUNK_SIZE} resolved to {tr.layout}")
    same = {k: res[k] == flat_csr[k] for k in SAME_KEYS}
    log(f"  chunk_size {FLAT_CHUNK_SIZE} against the flat batched+csr run: "
        f"{same}")
    check(all(same.values()), f"chunk_size {FLAT_CHUNK_SIZE} is not the "
          f"flat run: {same}")
    res["launches"] = launches
    out[path_name("batched", "csr", False, chunk=chunk)] = res
    del tr
    torch.cuda.empty_cache()
    return out


def profile_round(torch, fn, what="round"):
    """``fn()`` (one more round, or one serving step) under torch.profiler:
    the device's busy share of it (kernel time over wall time, the
    profiler's own host overhead included in the wall) and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log("  device time not measured: torch.profiler recorded no kernel")
        return {"wall_ms": wall_ms, "busy_ms": None, "launches": None}
    log(f"  profiled {what}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(r[1] for r in rows)} kernel launches")
    for ms, count, key in rows[:10]:
        log(f"    {ms:8.3f} ms {count:6d}x  {key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "launches": sum(r[1] for r in rows),
            "top": [{"ms": ms, "count": count, "kernel": key[:90]}
                    for ms, count, key in rows[:5]]}


# -- phases 4c and 5c: the paper's comparison baselines --------------------
# (name, class, keywords); FedAvg-SSL launches staleness_agg once a round
BASELINES = (("fedavg-ssl-partial", "FedAvgSSL", {"mode": "partial"}),
             ("fedavg-ssl-all", "FedAvgSSL", {"mode": "all"}),
             ("fedasync-ssl", "FedAsyncSSL", {}),
             ("local-ssl", "LocalSSL", {}))
BASELINE_KERNELS = ("masked_pseudo_ce", "masked_pseudo_ce_bwd")


def _events(tr):
    """What a baseline's schedule consists of: FedAvg-SSL's selections,
    FedAsync-SSL's arrivals in event order."""
    return getattr(tr, "selections", None) or getattr(tr, "arrivals", None)


def baseline_run(torch, port, ops, cls, kw, dev, rounds, init=None):
    """One baseline from ``make_dataset("basic", scale=0.02)``, its launch
    counters reset just before it; the client steps its run took are
    counted by wrapping its client epoch."""
    data = port.make_dataset("basic", scale=0.02, seed=0)
    ops.reset_launches()
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = getattr(port.baselines, cls)(
        data, port.FedS3AConfig(rounds=rounds, device=dev),
        init_params=init, **kw)
    steps, inner = [0], tr.client_epoch
    B = tr.cfg.batch_size

    def counted(params, opt, x, lr, masks):
        steps[0] += max((len(x) + B - 1) // B, 1)
        return inner(params, opt, x, lr, masks)

    tr.client_epoch = counted
    if dev == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = tr.train()
    if dev == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return SimpleNamespace(tr=tr, out=out, steps=steps[0],
                           launches=dict(ops.LAUNCHES), setup_s=t1 - t0,
                           s_per_round=(t2 - t1) / rounds,
                           params=port.params_to_numpy(tr.global_params))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _update_gap(torch, new, ref_new, old, tol):
    """How far one step's update on the card, ``new - old``, is from the
    CPU's, ``ref_new - old`` (all on the card): (||gap||^2, ||CPU
    update||^2, the share of elements whose update differs by more than
    ``tol``)."""
    gap2 = upd2 = 0.0
    off = n = 0
    for k in old:
        gap = new[k] - ref_new[k]
        upd = ref_new[k] - old[k]
        gap2 += float(gap.double().square().sum())
        upd2 += float(upd.double().square().sum())
        off += int((gap.abs() > tol).sum())
        n += gap.numel()
    return gap2, upd2, off / n


def _rel(gap2, upd2):
    return math.sqrt(gap2 / upd2) if upd2 else math.inf


# Local-SSL's update bounds (phase 4c). A card step's update may differ
# from the CPU's by at most STEP_REL (||gap|| / ||update||), and in at
# most STEP_SHARE of the elements by more than a tenth of the learning
# rate; over the run, sqrt(sum ||gap||^2 / sum ||update||^2) at most
# RUN_REL. Set from a run on an H100 (PERF.md §6): sound steps read at
# most 6.25e-4 and 1.64e-4, median 2.3e-6; a skipped step reads 1 and
# 0.58; the mask flipped on 2 rows moves a single step by as little as
# 4e-8 (a confident row's loss has almost no gradient), so it is held
# over the run instead.
STEP_REL, STEP_SHARE, RUN_REL = 5e-3, 1e-3, 5e-3
PLANT_ROWS = 2              # rows whose pseudo-label mask the plant flips


def _flipped_mask_loss(torch, real, rows, n_valid):
    """``masked_pseudo_ce`` with the pseudo-label mask flipped on the
    ``rows`` least confident of the batch's first ``n_valid`` (real) rows:
    a row it leaves out gets its pseudo-label CE, a row it keeps loses
    its loss."""
    def mpce(logits, threshold):
        loss, mask = real(logits, threshold)
        conf = torch.softmax(logits[:n_valid].detach(), dim=-1).amax(dim=-1)
        pick = conf.argsort()[:rows]
        ce = -torch.log_softmax(logits[pick], dim=-1).amax(dim=-1)
        on = mask[pick] > 0
        return (loss.index_put((pick,), torch.where(on, 0.0 * ce, ce)),
                mask.index_put((pick,), (~on).to(mask.dtype)))
    return mpce


TIE_REL = 1e-5     # a decision within rounding: max-prob within TIE_REL
                   # (relative) of theta, or top-2 logits within TIE_REL
                   # (relative) of each other


def _recording(real, seen):
    """``masked_pseudo_ce`` that keeps each call's logits and mask."""
    def mpce(logits, threshold):
        loss, mask = real(logits, threshold)
        seen.append((logits.detach(), mask.detach()))
        return loss, mask
    return mpce


def _near_decision(torch, logits):
    """(n,) bool: rows within rounding of a pseudo-label decision."""
    lg = logits.double().cpu()
    maxp = torch.softmax(lg, dim=-1).amax(dim=-1)
    top = lg.topk(2, dim=-1).values
    return ((maxp - THETA).abs() <= TIE_REL * THETA) | \
        ((top[:, 0] - top[:, 1]).abs()
         <= TIE_REL * top.abs().amax(dim=-1))


def _decisions(torch, a, b, n_valid):
    """Rows (of the first ``n_valid``) whose pseudo-label argmax or mask
    differ between calls ``a`` and ``b`` (each (logits, mask)); which of
    them are within rounding of a decision on either side; and which
    change the loss (the mask differs, or the argmax on a row masked in:
    a masked-out row's label enters no loss)."""
    (la, ma), (lb, mb) = a, b
    la, lb = la[:n_valid].cpu(), lb[:n_valid].cpu()
    ma, mb = ma[:n_valid].cpu() > 0, mb[:n_valid].cpu() > 0
    label = la.argmax(dim=-1) != lb.argmax(dim=-1)
    effective = (ma != mb) | (label & ma)
    tie = _near_decision(torch, la) | _near_decision(torch, lb)
    rows = torch.nonzero(label | (ma != mb)).flatten().tolist()
    return rows, [bool(tie[r]) for r in rows], \
        [bool(effective[r]) for r in rows]


def _row_detail(torch, call, rows):
    """Per row of ``call`` (logits, mask): argmax, mask, max-prob and the
    top-2 logits' relative gap, for the record."""
    lg, mask = call[0][rows].double().cpu(), call[1][rows].cpu()
    top = lg.topk(2, dim=-1).values
    return [{"argmax": int(lg[i].argmax()), "mask": bool(mask[i] > 0),
             "max_prob": float(torch.softmax(lg[i], dim=-1).max()),
             "top2_rel_gap": float((top[i, 0] - top[i, 1]).abs()
                                   / top[i].abs().max())}
            for i in range(len(rows))]


def _sign_flips(torch, new, ref_new, old):
    """Elements whose update on the card, ``new - old``, has another sign
    than the CPU's, ``ref_new - old``, one of them nonzero."""
    flips = 0
    for k in old:
        a, b = torch.sign(new[k] - old[k]), torch.sign(ref_new[k] - old[k])
        flips += int(((a != b) & ((a != 0) | (b != 0))).sum())
    return flips


def local_ssl_stepwise(torch, port, init, cpu_run, rounds=2):
    """Local-SSL card against CPU one update at a time. Its run is 2 x
    (a 5-step server epoch + a 91-step client epoch over the pooled data)
    on one model; a free run on the card drifts from the CPU's past atol
    1e-4 / rtol 1e-3 (printed), and an end-point bound cannot tell that
    drift from a fault, since one Adam step moves an element by about lr
    = 1e-4. So each update is held instead: the card takes the step from
    the CPU's state (parameters and both Adam states), and its update is
    compared with the CPU's (``_update_gap``): every step within
    ``STEP_REL`` / ``STEP_SHARE``, the run within ``RUN_REL``. Controls,
    taken from the same states: a skipped step must leave the step bounds
    at every step, and the steps taken with the pseudo-label mask flipped
    on ``PLANT_ROWS`` rows must leave the run bound. The steps follow
    ``LocalSSL.train``'s schedule (one Adam step a batch; a server epoch
    is one unit): the CPU's last state must be ``cpu_run``'s parameters (a
    whole ``train()`` on the CPU) bit for bit.

    The decision trace: at every client step the card's pseudo-label
    argmax and mask from the CPU's state are held against the CPU's; a row
    that differs must be within rounding of a decision (``TIE_REL``), or
    the port is at fault. A free run on the card from the same initial
    weights is stepped beside the CPU's, and the first step at which any
    of its decisions differs from the CPU's is recorded with its rows and
    the parameter gap there. The update's sign flips against the CPU's
    are counted at every step."""
    import numpy as np
    from repro_torch.core import pseudo_label
    from repro_torch.optimizer import adam_init
    c, g = (port.baselines.LocalSSL(
        port.make_dataset("basic", scale=0.02, seed=0),
        port.FedS3AConfig(rounds=rounds, device=dev), init_params=init)
        for dev in ("cpu", "cuda"))
    dev = g.device
    B, lr = c.cfg.batch_size, c.cfg.lr
    tol = 0.1 * lr
    x_all = np.concatenate([cl["x"] for cl in c.data["clients"]])
    sx, sy = c.data["server"]["x"], c.data["server"]["y"]
    nb = (len(x_all) + B - 1) // B
    cpu = [c.global_params, adam_init(c.global_params),
           adam_init(c.global_params)]
    real_ops = pseudo_label.kops
    runs = {"sound": [], "skipped": [], "mask_flip": []}
    free = [_to(t, dev) for t in cpu]     # the card's free run
    trace = {"steps": 0, "client_steps": 0, "rows_compared": 0,
             "rows_differ": 0, "rows_differ_tie": 0, "nontie": [],
             "sign_flips": [], "free_rows_differ": 0,
             "free_rows_effective": 0, "free_first": None,
             "free_first_effective": None}
    for _ in range(rounds):
        units = [None] + [x_all[b * B:(b + 1) * B] for b in range(nb)]
        for xb in units:
            def step(tr, st, seen=None):
                if xb is None:        # the server epoch, Adam state 1
                    p, o, _ = tr.server_epoch(st[0], st[1], sx, sy, lr, None)
                    return [p, o, st[2]]
                if seen is not None:
                    pseudo_label.kops = SimpleNamespace(
                        masked_pseudo_ce=_recording(
                            real_ops.masked_pseudo_ce, seen))
                try:
                    p, o, _ = tr.client_epoch(st[0], st[2], xb, lr, None)
                finally:
                    pseudo_label.kops = real_ops
                return [p, st[1], o]
            start = [_to(t, dev) for t in cpu]
            seen = {"card": [], "cpu": [], "free": []}
            taken = {"sound": step(g, start, seen["card"])[0],
                     "skipped": start[0]}
            if xb is not None:
                pseudo_label.kops = SimpleNamespace(
                    masked_pseudo_ce=_flipped_mask_loss(
                        torch, real_ops.masked_pseudo_ce, PLANT_ROWS,
                        len(xb)))
                try:
                    taken["mask_flip"] = step(
                        g, [_to(t, dev) for t in cpu])[0]
                finally:
                    pseudo_label.kops = real_ops
            free_before = free[0]
            free = step(g, free, seen["free"])
            prev_cpu = cpu[0]
            cpu = step(c, cpu, seen["cpu"])
            ref = _to(cpu[0], dev)
            for what, p in taken.items():
                runs[what].append(_update_gap(torch, p, ref, start[0], tol))
            trace["sign_flips"].append(_sign_flips(torch, taken["sound"], ref,
                                                   start[0]))
            i = trace["steps"]
            trace["steps"] += 1
            if xb is None:
                continue
            trace["client_steps"] += 1
            trace["rows_compared"] += len(xb)
            rows, tie, _ = _decisions(torch, seen["card"][0],
                                      seen["cpu"][0], len(xb))
            trace["rows_differ"] += len(rows)
            trace["rows_differ_tie"] += sum(tie)
            trace["nontie"] += [{"step": i, "row": r} for r, t in
                                zip(rows, tie) if not t]
            rows, tie, eff = _decisions(torch, seen["free"][0],
                                        seen["cpu"][0], len(xb))
            trace["free_rows_differ"] += len(rows)
            trace["free_rows_effective"] += sum(eff)
            for key, pick in (("free_first", rows),
                              ("free_first_effective",
                               [r for r, e in zip(rows, eff) if e])):
                if trace[key] is None and pick:
                    trace[key] = {
                        "step": i, "rows": pick,
                        "within_rounding": [tie[rows.index(r)]
                                            for r in pick],
                        "param_gap_max": max(
                            float((free_before[k].cpu() - prev_cpu[k])
                                  .abs().max()) for k in prev_cpu),
                        "card": _row_detail(torch, seen["free"][0], pick),
                        "cpu": _row_detail(torch, seen["cpu"][0], pick)}
    out = {"steps": len(runs["sound"]), "tol": tol, "step_rel_bound":
           STEP_REL, "step_share_bound": STEP_SHARE, "run_rel_bound":
           RUN_REL, "plant_rows": PLANT_ROWS}
    for what, seen in runs.items():
        rels = [_rel(g2, u2) for g2, u2, _ in seen]
        out[what] = {
            "run_rel": _rel(sum(x[0] for x in seen), sum(x[1] for x in seen)),
            "step_rel_min": min(rels), "step_rel_median":
            statistics.median(rels), "step_rel_max": max(rels),
            "step_share_min": min(x[2] for x in seen),
            "step_share_max": max(x[2] for x in seen),
            "steps_outside": sum(r > STEP_REL or x[2] > STEP_SHARE
                                 for r, x in zip(rels, seen))}
    flips = trace.pop("sign_flips")
    out["decisions"] = {**trace, "tie_rel": TIE_REL,
                        "sign_flips_step0": flips[0],
                        "sign_flips_max": max(flips),
                        "sign_flips_median": statistics.median(flips)}
    so, sk, mf = out["sound"], out["skipped"], out["mask_flip"]
    log(f"  local-ssl update by update, card vs CPU: {out['steps']} updates "
        f"(server epochs counted as one); the card's update off the CPU's "
        f"by {so['step_rel_median']:.3g} median, {so['step_rel_max']:.3g} "
        f"most (relative norm; bound {STEP_REL:g}), at most "
        f"{so['step_share_max']:.3g} of the elements by > {tol:g} (bound "
        f"{STEP_SHARE:g}), {so['run_rel']:.3g} over the run (bound "
        f"{RUN_REL:g}). Planted: a skipped step at least "
        f"{sk['step_rel_min']:.3g} / {sk['step_share_min']:.3g}, outside at "
        f"{sk['steps_outside']} of {out['steps']} steps; the mask flipped "
        f"on {PLANT_ROWS} rows {mf['run_rel']:.3g} over the run, a step "
        f"{mf['step_rel_min']:.3g} to {mf['step_rel_max']:.3g}, outside the "
        f"step bounds at {mf['steps_outside']} of {len(runs['mask_flip'])}")
    d = out["decisions"]
    log(f"  local-ssl decision trace, card from the CPU's state: "
        f"{d['steps']} steps ({d['client_steps']} with pseudo-labels), "
        f"{d['rows_compared']} rows; argmax or mask differ on "
        f"{d['rows_differ']} rows, {d['rows_differ_tie']} of them within "
        f"{TIE_REL:g} (relative) of a decision, {len(d['nontie'])} not "
        f"({d['nontie'][:5]}); update sign flips against the CPU's: "
        f"{d['sign_flips_step0']} at step 0, median "
        f"{d['sign_flips_median']:g}, most {d['sign_flips_max']}")
    log(f"  local-ssl free runs (card and CPU from the same weights): "
        f"decisions differ on {d['free_rows_differ']} rows of the run, "
        f"{d['free_rows_effective']} of them changing the loss")
    for key, what in (("free_first", "differing decision"),
                      ("free_first_effective", "decision changing the "
                                               "loss")):
        ff = d[key]
        log(f"    first {what}: " + (
            "none" if ff is None else
            f"step {ff['step']}, rows {ff['rows']} (within rounding "
            f"{ff['within_rounding']}), parameter gap there "
            f"{ff['param_gap_max']:.3g}; card {ff['card']}, CPU "
            f"{ff['cpu']}"))
    check(not d["nontie"], f"Local-SSL: {len(d['nontie'])} pseudo-label "
          f"decisions differ from equal state on rows not within rounding: "
          f"{d['nontie'][:10]}")
    # read out whole before any check, so a failing run still shows them
    for i, (g2, u2, share) in enumerate(runs["sound"]):
        check(_rel(g2, u2) <= STEP_REL and share <= STEP_SHARE,
              f"Local-SSL step {i}: the card's update from the CPU's state "
              f"is {_rel(g2, u2):.3g} off (relative norm), {share:.3g} of "
              f"the elements off by more than {tol:g}")
    check(so["run_rel"] <= RUN_REL, f"Local-SSL: the card's updates are "
          f"{so['run_rel']:.3g} off the CPU's over the run")
    check(sk["steps_outside"] == out["steps"],
          "Local-SSL: a planted skipped step stays inside the step bounds")
    check(mf["run_rel"] > RUN_REL, "Local-SSL: the planted mask flip stays "
          "inside the run bound")
    check(all(np.array_equal(v, cpu_run[k]) for k, v in
              port.params_to_numpy(cpu[0]).items()),
          "Local-SSL: the steps do not replay LocalSSL.train")
    return out


def baselines_gpu_vs_cpu(torch, port, ops, rounds=2):
    """Phase 4c: each baseline on the card and on the CPU at full width
    from the same initial weights, ``CNN_CONFIG`` set to dropout 0 for this
    check only: selections, arrivals, ART, forced syncs and ACO exact; for
    FedAvg-SSL and FedAsync-SSL global parameters within atol 1e-4 / rtol
    1e-3 and metrics within 1e-4; Local-SSL's whole run is printed and its
    every update held to the CPU's (``local_ssl_stepwise``)."""
    import numpy as np
    full = port.baselines.CNN_CONFIG
    cnn = dataclasses.replace(full, dropout=0.0)
    gen = torch.Generator().manual_seed(2)
    init = port.params_to_numpy(port.init_cnn(cnn, gen))
    port.baselines.CNN_CONFIG = cnn
    out = {}
    try:
        for name, cls, kw in BASELINES:
            r = 4 * rounds if cls == "FedAsyncSSL" else rounds
            g, c = (baseline_run(torch, port, ops, cls, kw, dev, r, init)
                    for dev in ("cuda", "cpu"))
            worst, outside, total = _param_diff(np, g.params, c.params)
            mdiff = max(abs(g.out["metrics"][k] - c.out["metrics"][k])
                        for k in g.out["metrics"])
            same_art = g.out["art"] == c.out["art"] or (
                math.isnan(g.out["art"]) and math.isnan(c.out["art"]))
            same_aco = g.out["aco"] == c.out["aco"] or (
                math.isnan(g.out["aco"]) and math.isnan(c.out["aco"]))
            log(f"  {name}, card vs CPU, {r} rounds: schedule equal "
                f"{_events(g.tr) == _events(c.tr)}, ART equal {same_art}, "
                f"forced syncs {g.out.get('forced_syncs')} / "
                f"{c.out.get('forced_syncs')}, max |diff| {worst:.3g} "
                f"({outside} of {total} outside atol 1e-4 + rtol 1e-3), "
                f"max |metric diff| {mdiff:.3g}, ACO equal {same_aco}; "
                f"card {g.s_per_round:.3f} s a round, CPU "
                f"{c.s_per_round:.3f}")
            check(_events(g.tr) == _events(c.tr),
                  f"{name}: schedules differ between card and CPU")
            check(same_art and same_aco, f"{name}: ART or ACO differ")
            check(g.out.get("forced_syncs") == c.out.get("forced_syncs"),
                  f"{name}: forced syncs differ")
            if cls == "LocalSSL":
                out[name] = {"free_run_diff": worst, "free_run_outside":
                             outside, "free_run_metric_diff": mdiff,
                             **local_ssl_stepwise(torch, port, init,
                                                  c.params, rounds)}
                continue
            check(outside == 0, f"{name}: parameters differ past atol 1e-4 "
                  "+ rtol 1e-3")
            check(mdiff < 1e-4, f"{name}: metrics differ by {mdiff}")
            out[name] = {"max_diff": worst, "metric_diff": mdiff}
    finally:
        port.baselines.CNN_CONFIG = full
    return out


def baselines_full_width(torch, port, ops, rounds=3):
    """Phase 5c: each baseline on the card at full width with the paper's
    dropout: one ``masked_pseudo_ce`` launch (and one backward) a client
    step, ``staleness_agg`` once a FedAvg round and never otherwise, no
    compaction kernel."""
    import numpy as np
    out = {}
    for name, cls, kw in BASELINES:
        r = 4 * rounds if cls == "FedAsyncSSL" else rounds
        b = baseline_run(torch, port, ops, cls, kw, "cuda", r)
        m, la = b.out["metrics"], b.launches
        n = sum(v.size for v in b.params.values())
        check(n == N_FULL, f"{name} has {n} parameters, expected {N_FULL}")
        check(all(np.isfinite(v).all() for v in b.params.values()),
              f"{name}: non-finite global parameters")
        check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()),
              f"{name}: metrics out of range: {m}")
        fedavg = cls == "FedAvgSSL"
        kernels = BASELINE_KERNELS + (("staleness_agg",) if fedavg else ())
        check_launches(la, kernels, name,
                       {"staleness_agg": 1} if fedavg else None, [None] * r)
        check(la["masked_pseudo_ce"] == b.steps,
              f"{name}: {la['masked_pseudo_ce']} masked_pseudo_ce launches "
              f"for {b.steps} client steps")
        log(f"  {name}: {r} rounds, {b.s_per_round:.3f} s a round (set-up "
            f"{b.setup_s:.3f} s), accuracy {m['accuracy']:.6f}, F1 "
            f"{m['f1']:.6f}, FPR {m['fpr']:.6f}, ART {b.out['art']:.3f}, "
            f"ACO {b.out['aco']}, forced syncs "
            f"{b.out.get('forced_syncs')}, {b.steps} client steps; "
            f"launches {la}")
        out[name] = {"rounds": r, "s_per_round": b.s_per_round,
                     "setup_s": b.setup_s, **m, "art": b.out["art"],
                     "aco": b.out["aco"], "client_steps": b.steps,
                     "forced_syncs": b.out.get("forced_syncs"),
                     "launches": la}
    return out


# -- phase 5d: the fleet ---------------------------------------------------
FLEET_CNN = dict(name="feds3a-cnn-fleet", conv_filters=(8, 8), hidden=16)
FLEET_POOL, FLEET_SCALE = 64, 0.001
FLEET_M, FLEET_K_FULL = 1000, 64          # (i): full width
FLEET_M_BIG, FLEET_K = 1_000_000, 512     # (ii): the fleet width
PEAK_SLACK = 64 << 20     # (ii): peak device bytes may exceed M = 1,000's


def stage_peak(torch, tr, method):
    """One more round with the trainer's ``method`` (the upload-encode
    stage: ``_upload`` flat, ``_chunk_upload`` chunked) wrapped to read
    its own peak: ``max_memory_allocated`` above what was allocated when
    it began, the peak statistics reset at its start. Run after the timed
    rounds, once their results are read; the wrapper is gone on return."""
    inner = getattr(tr, method)
    peaks = []

    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        return out

    setattr(tr, method, wrapped)
    try:
        tr.run_round()
    finally:
        delattr(tr, method)
    return peaks[0]


def drive_fleet(torch, port, ops, M, K, store, cnn, rounds, warmup=0,
                paged_dir=None, profile=False, chunk=None, stage=False):
    """Batched + csr + EF on ``make_fleet_dataset(M, pool=64,
    scale=0.001)``, K participants a round (``chunk``: the chunked
    layout's config), the counters reset just before and the peak device
    memory measured from there; ``warmup`` of the rounds untimed; with
    ``stage``, one more round after the results are read that measures
    the upload-encode stage's own peak (``stage_peak``); with
    ``profile``, one more round under the profiler."""
    data = port.make_fleet_dataset(M, pool=FLEET_POOL, scale=FLEET_SCALE,
                                   seed=0)
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = port.FedS3ATrainer(data, port.FedS3AConfig(
        rounds=rounds, C=K / M, cnn=cnn, engine="batched",
        wire_format="csr", error_feedback=True, client_store=store,
        paged_dir=paged_dir, **(chunk or {})))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(warmup):
        tr.run_round()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(rounds - warmup):
        tr.run_round()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    store_s = store_seconds(tr)
    m = tr.evaluate()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    name = f"fleet M={M} K={K} {store}" + (" chunked" if chunk else "")
    parts = [len(log.participants) for log in tr.logs]
    check(parts == [K] * rounds, f"{name}: participants a round {parts}")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()),
          f"{name}: metrics out of range: {m}")
    check(tr.chunked == bool(chunk), f"{name}: layout {tr.layout}")
    check_launches(launches, CSR_KERNELS, name,
                   {"csr_compact": 27, "staleness_agg": 9} if chunk else
                   {"csr_compact": 3}, parts)
    res = {"M": M, "K": K, "store": store, "chunked": bool(chunk),
           "rounds": rounds,
           "warmup_rounds": warmup, "n_params": int(tr._global_flat.numel()),
           "setup_s": t1 - t0, "s_per_round": (t3 - t2) / (rounds - warmup),
           "accuracy": m["accuracy"], "aco": tr.comm.aco,
           "participants": parts, "forced": [len(log.forced)
                                             for log in tr.logs],
           "client_state_device_bytes": tr.client_state_device_bytes(),
           "client_state_host_bytes": tr.client_state_host_bytes(),
           "resident_equiv_bytes": tr.client_state_resident_equiv_bytes(),
           "residual_store_bytes": tr.residual_store_bytes(),
           "peak_device_bytes": peak,
           "peak_delta_device_bytes": tr.peak_delta_device_bytes(),
           "upload_stage_peak_bytes": None,
           "digest": params_digest(port, tr), "launches": launches,
           "paged_dir": paged_dir is not None,
           "store_host_s_per_round": None if store_s is None else
           {k: v / rounds for k, v in store_s.items()}}
    if stage:
        res["upload_stage_peak_bytes"] = stage_peak(
            torch, tr, "_chunk_upload" if chunk else "_upload")
    log(f"  {name}: N = {res['n_params']}, set-up {res['setup_s']:.2f} s, "
        f"{res['s_per_round']:.3f} s a round ({rounds - warmup} timed), "
        f"forced a round {res['forced']}, accuracy {m['accuracy']:.6f}, ACO "
        f"{res['aco']:.6f}; client state on the device "
        f"{res['client_state_device_bytes']} B, host (nominal) "
        f"{res['client_state_host_bytes']} B, resident equivalent "
        f"{res['resident_equiv_bytes']} B, peak device memory "
        f"{res['peak_device_bytes']} B, upload stage's own peak "
        f"{res['upload_stage_peak_bytes']} B (the reference's analytic "
        f"peak_delta_device_bytes {res['peak_delta_device_bytes']} B); "
        f"paged store host s a round "
        f"{res['store_host_s_per_round']}; launches {launches}")
    if profile:
        res["profiled_round"] = profile_round(torch, tr.run_round,
                                              f"{name} round")
    del tr
    torch.cuda.empty_cache()
    return res


def _mem_available():
    """The host's MemAvailable in bytes (Linux), or None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def fleet(torch, port, ops):
    """Phase 5d. (i) M = 1,000 at full width, 64 participants a round,
    resident then paged: bit-equal, the paged device state a window of the
    participants. (ii) M = 1,000,000 at the fleet width, 512 participants,
    paged, 1 warm-up and 2 timed rounds, beside M = 1,000 with the same K:
    the device's client-state bytes must be equal."""
    full = [drive_fleet(torch, port, ops, FLEET_M, FLEET_K_FULL, store,
                        port.CNNConfig(), 3, profile=True,
                        stage=store == "resident")
            for store in ("resident", "paged")]
    same = {k: full[0][k] == full[1][k] for k in ("accuracy", "aco",
                                                  "participants", "digest",
                                                  "launches")}
    log(f"  M = {FLEET_M}, full width: paged against resident {same}")
    check(all(same.values()), f"fleet M = {FLEET_M}: paged differs from "
          f"resident: {same}")
    check(full[1]["client_state_device_bytes"] <
          full[0]["client_state_device_bytes"],
          f"fleet M = {FLEET_M}: the paged store holds no less on the device")
    cnn = port.CNNConfig(**FLEET_CNN)
    small = drive_fleet(torch, port, ops, FLEET_M, FLEET_K, "paged", cnn, 3,
                        1)
    n = small["n_params"]
    rcap = math.ceil(0.25 * n)
    nominal = FLEET_M_BIG * rcap * 8
    avail = _mem_available()
    spill = avail is None or nominal > avail // 2
    log(f"  M = {FLEET_M_BIG}: nominal host pages {nominal} B, host memory "
        f"available {avail} B: "
        + ("pages memory-mapped under a temporary directory" if spill else
           "pages in anonymous memory (committed lazily)"))
    tmp = tempfile.mkdtemp(prefix="fleet_pages_") if spill else None
    try:
        big = drive_fleet(torch, port, ops, FLEET_M_BIG, FLEET_K, "paged",
                          cnn, 3, 1, paged_dir=tmp)
    finally:
        if tmp is not None:
            for f in os.listdir(tmp):
                os.remove(os.path.join(tmp, f))
            os.rmdir(tmp)
    log(f"  client state on the device: M = {FLEET_M} "
        f"{small['client_state_device_bytes']} B, M = {FLEET_M_BIG} "
        f"{big['client_state_device_bytes']} B")
    check(big["client_state_device_bytes"] ==
          small["client_state_device_bytes"],
          "the device's client-state bytes grow with M")
    # the window bytes are K-sized by construction; the peak is the witness
    # that nothing of size M (a participation row, a mask) reached the card
    check(big["peak_device_bytes"] <= small["peak_device_bytes"]
          + PEAK_SLACK, f"peak device memory grows with M: "
          f"{small['peak_device_bytes']} B at M = {FLEET_M}, "
          f"{big['peak_device_bytes']} B at M = {FLEET_M_BIG}")
    chunked = [drive_fleet(torch, port, ops, FLEET_M, FLEET_K_FULL, store,
                           port.CNNConfig(), 3, chunk=CHUNK, stage=True)
               for store in ("resident", "paged")]
    same = {k: chunked[0][k] == chunked[1][k] for k in ("accuracy", "aco",
                                                        "participants",
                                                        "digest",
                                                        "launches")}
    flat_peak = full[0]["upload_stage_peak_bytes"]
    log(f"  (iii) M = {FLEET_M} chunked: paged against resident {same}; "
        f"upload stage's own peak: flat resident {flat_peak} B, chunked "
        f"resident {chunked[0]['upload_stage_peak_bytes']} B, paged "
        f"{chunked[1]['upload_stage_peak_bytes']} B")
    check(all(same.values()), f"fleet M = {FLEET_M} chunked: paged differs "
          f"from resident: {same}")
    check(all(c["upload_stage_peak_bytes"] < flat_peak for c in chunked),
          "the chunked upload stage's peak is not below the flat one's")
    return {"full_width": full, "fleet_width": [small, big],
            "chunked_full_width": chunked,
            "nominal_host_page_bytes": nominal}


# -- phase 5f: faults and fleet checkpoints --------------------------------
# REFERENCE_CHURN with 5% corrupt uploads, a 700 s round deadline and a
# quorum floor of 2 on phase 5's data; FAULT_ROUNDS is the fewest rounds in
# which every class of FAULT_CLASSES fires (the last to fire is a resync,
# in round 7; the phase prints each class's first round)
FAULT_ROUNDS = 7
FAULT_CLASSES = ("crashes", "lost", "corrupted", "departed", "rejoined",
                 "resynced", "degraded")
FAULT_KW = {"round_deadline": 700.0, "quorum_floor": 2}
# name -> (engine, wire, error feedback, client store, chunked)
FAULT_RUNS = {
    "F1": ("batched", "csr", False, "resident", False),
    "F2": ("sequential", "csr", False, "resident", False),
    "F3": ("batched", "csr_q", True, "resident", False),
    "F3p": ("batched", "csr_q", True, "paged", False),
    "F4": ("batched", "csr_q", True, "resident", True),
    "F5": ("batched", "dense_masked", True, "resident", False),
}
F4_TWIN = ("sequential", "csr_q", True, "resident", True)
RESUMED = ("F3", "F3p", "F4")
CPU_CNN = {"conv_filters": (8, 8), "hidden": 16}   # the CPU twins' CNN
# F1 against F2, the stacked-engine tolerance. Metrics: the reference's own
# batched engine against its sequential one under faults differs by up to
# 3.33e-3 in its metrics after the chaos suite's 50 rounds on the reduced
# CNN (tests/reference_spread.py --cell chaos). ACO: at full width on an H100
# the port's two engines differ over these 7 rounds by up to 1.01e-2
# without faults and 2.18e-3 with them, over seeds 0-4
# (tools/engine_drift.py): their sums round differently and ties at the
# sampled threshold fall apart round by round (ROADMAP.md section 3)
FAULT_METRIC_TOL, FAULT_ACO_TOL = 3.4e-3, 1.5e-2


def fault_config(port, spec, rounds=FAULT_ROUNDS, faulted=True, **kw):
    engine, wire, ef, store, chunked = spec
    faults = dict(traffic=dataclasses.replace(
        port.REFERENCE_CHURN, corrupt_prob=0.05), **FAULT_KW) \
        if faulted else {}
    return port.FedS3AConfig(
        rounds=rounds, engine=engine, wire_format=wire, error_feedback=ef,
        client_store=store, **faults, **(CHUNK if chunked else {}), **kw)


def fault_trace(tr):
    """Everything the fault trace fixes, round by round, in JSON form."""
    return json.loads(json.dumps([
        [l.participants, sorted(l.stalenesses.items()), l.forced, l.lost,
         l.corrupted, l.departed, l.rejoined, l.resynced, l.quorum,
         l.target_k, l.degraded, l.deadline_hit, l.crashes, l.time, l.art]
        for l in tr.logs]))


def _fired(log, k):
    v = getattr(log, k)
    return v if isinstance(v, (bool, int)) else len(v)


def fault_counts(tr):
    """How often each event class fired over the run, and the first round
    (from 1) in which it did."""
    keys = FAULT_CLASSES + ("forced", "deadline_hit")
    counts = {k: sum(_fired(l, k) for l in tr.logs) for k in keys}
    counts["first_round"] = {k: next((i + 1 for i, l in enumerate(tr.logs)
                                      if _fired(l, k)), None) for k in keys}
    return counts


def cpu_fault_traces(out_path):
    """The CPU twins of phase 5f's runs: each run's config at the reduced
    CNN on the CPU, with the same data and seed; writes their traces as
    JSON. Run in a subprocess beside the card runs."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(2)
    from repro_torch.configs.feds3a_cnn import CNNConfig
    from repro_torch.core import REFERENCE_CHURN
    from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer
    from repro_torch.data import make_dataset
    port = SimpleNamespace(FedS3AConfig=FedS3AConfig,
                           REFERENCE_CHURN=REFERENCE_CHURN)
    data = make_dataset("basic", scale=0.02)
    out = {}
    for name, spec in FAULT_RUNS.items():
        t0 = time.perf_counter()
        tr = FedS3ATrainer(data, fault_config(port, spec, device="cpu",
                                              cnn=CNNConfig(**CPU_CNN)))
        tr.train()
        out[name] = {"trace": fault_trace(tr), "counts": fault_counts(tr),
                     "seconds": time.perf_counter() - t0}
    Path(out_path).write_text(json.dumps(out))


def state_digests(tr):
    """SHA-256 of each part of a trainer's end state: the flat parameters,
    the ring, the client versions, the detached mask and the residual
    pages (the paged store's valid pages, or the resident arrays)."""
    def sha(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            a = a.detach().cpu().numpy() if hasattr(a, "detach") else a
            h.update(str(a.dtype).encode() + str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    out = {"flat": sha(tr._global_flat), "ring": sha(tr.store.ring),
           "client_version": sha(tr.store.client_version),
           "detached": sha(tr.store.detached)}
    if tr.cstore is not None:
        st = tr.cstore.state_dict()
        out["residuals"] = sha(st["ids"], *st["pages"]) if tr.paged else \
            sha(*st["arrays"])
    return out


def fault_run(torch, port, ops, data, name, spec, rounds=FAULT_ROUNDS,
              faulted=True, **kw):
    """One faulted run at full width, the launch counters set to 0 just
    before it and read just after; each kernel's launches are held to the
    count its table gives for the run's own K a round."""
    engine, wire, ef, store, chunked = spec
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = port.FedS3ATrainer(data, fault_config(port, spec, rounds, faulted,
                                               **kw))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = tr.train()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    ks = [len(log.participants) for log in tr.logs]
    check(tr.engine == engine and tr.chunked == chunked and
          port.cnn_param_count(tr.cnn) == N_FULL,
          f"{name} ran {tr.engine}, layout {tr.layout}")
    m = out["metrics"]
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()),
          f"{name}: metrics out of range: {m}")
    check(0.0 < out["aco"] < 1.0, f"{name}: ACO out of range: {out['aco']}")
    check(bool(torch.isfinite(tr._global_flat).all()),
          f"{name}: non-finite global parameters")
    if chunked:
        per_round = CHUNK_PER_ROUND[(wire, ef)]
    else:
        per_round = dict(PER_ROUND.get((engine, wire, ef), {}))
        if engine == "batched":
            per_round["staleness_agg"] = 1
        if wire == "dense_masked":
            per_round["sparse_delta"] = 1 if engine == "sequential" else 2
    check_launches(launches, PATH_KERNELS[(engine, wire, ef)], name,
                   per_round, ks)
    s_round = (t2 - t1) / rounds
    label = path_name(engine, wire, ef, store, CHUNK if chunked else None)
    log(f"  {name} {label}: {rounds} rounds, K a round {ks}, "
        f"{s_round:.3f} s a round "
        f"(set-up {t1 - t0:.3f} s), accuracy {m['accuracy']:.6f}, ACO "
        f"{out['aco']:.6f}, fleet {out['fleet']}; launches {launches}")
    return tr, out, {"s_per_round": s_round, "setup_s": t1 - t0,
                     "accuracy": m["accuracy"], "metrics": m,
                     "aco": out["aco"], "fleet": out["fleet"], "ks": ks,
                     "launches": launches, "digest": params_digest(port, tr),
                     "trace": fault_trace(tr), "counts": fault_counts(tr),
                     "state": state_digests(tr), "chunk_stored_share": None}


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir())


def resume_run(torch, port, data, name, spec, root, whole):
    """Train half the rounds, save (in the background, then at once),
    restore onto a fresh trainer and train the rest: the end state must be
    the uninterrupted run's ``whole`` bit for bit. Returns the checkpoint's
    bytes and the save / exposure / restore seconds."""
    half = FAULT_ROUNDS // 2
    cfg = fault_config(port, spec, checkpoint_dir=str(root))
    tr = port.FedS3ATrainer(data, cfg)
    tr.train(half)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.save_checkpoint(wait=False)
    t1 = time.perf_counter()
    tr._ckpt_drain()
    t2 = time.perf_counter()
    path = tr.save_checkpoint(wait=True)
    t3 = time.perf_counter()
    del tr
    torch.cuda.empty_cache()
    fresh = port.FedS3ATrainer(data, cfg)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    got = fresh.restore()
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    check(got == half, f"{name}: restored round {got}, saved {half}")
    out = fresh.train(FAULT_ROUNDS - half)
    res = {"ckpt_bytes": _dir_bytes(path), "save_s": t3 - t2,
           "exposure_s": t1 - t0, "background_write_s": t2 - t0,
           "restore_s": t5 - t4}
    same = {"state": state_digests(fresh) == whole["state"],
            "trace": fault_trace(fresh) == whole["trace"],
            "aco": out["aco"] == whole["aco"],
            "fleet": out["fleet"] == whole["fleet"],
            "metrics": out["metrics"] == whole["metrics"]}
    log(f"  {name} resumed at round {half}: checkpoint {res['ckpt_bytes']} "
        f"B, save(wait=True) {res['save_s']:.3f} s, save(wait=False) "
        f"exposure {res['exposure_s'] * 1e3:.2f} ms (its write "
        f"{res['background_write_s']:.3f} s), restore {res['restore_s']:.3f}"
        f" s; bit-equal to the uninterrupted run: {same}")
    check(all(same.values()), f"{name}: the resumed run differs: {same}")
    del fresh
    torch.cuda.empty_cache()
    return res


def _drift(a, b):
    """(max |metric diff|, |ACO diff|) of two runs' results."""
    return (max(abs(a["metrics"][k] - b["metrics"][k]) for k in a["metrics"]),
            abs(a["aco"] - b["aco"]))


def faults(torch, port, ops):
    """Phase 5f. F1-F5 (``FAULT_RUNS``) at full width under faults, each
    trace equal to its CPU twin's (a subprocess, the reduced CNN) and to
    F1's; F3p bit-equal to F3 and F4 to its sequential twin; F1 and F2
    within the stacked-engine tolerance; F3, F3p and F4 resumed from a
    mid-run checkpoint bit for bit, and F3 once more with
    ``checkpoint_every=5`` through ``train()``, equal to F3."""
    import shutil
    tmp = Path(tempfile.mkdtemp(prefix="fleet-ckpt-"))
    cpu_out, cpu_log = tmp / "cpu_traces.json", tmp / "cpu_traces.log"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    with open(cpu_log, "w") as f:
        cpu = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                "--fault-traces", str(cpu_out)], env=env,
                               stdout=f, stderr=subprocess.STDOUT)
    try:
        data = port.make_dataset("basic", scale=0.02)
        runs, keep = {}, {}
        for name, spec in FAULT_RUNS.items():
            tr, out, res = fault_run(torch, port, ops, data, name, spec)
            runs[name] = res
            del tr
            torch.cuda.empty_cache()
        _, _, twin = fault_run(torch, port, ops, data, "F4 sequential twin",
                               F4_TWIN)
        runs["F4 sequential twin"] = twin
        counts = runs["F1"]["counts"]
        log(f"  event classes over {FAULT_ROUNDS} rounds: {counts}")
        check(all(counts[c] > 0 for c in FAULT_CLASSES) and
              max(counts["first_round"][c] for c in FAULT_CLASSES) ==
              FAULT_ROUNDS, f"an event class never fired, or all fire "
              f"before round {FAULT_ROUNDS}: {counts}")
        for name, res in runs.items():
            check(res["trace"] == runs["F1"]["trace"],
                  f"{name}: trace differs from F1's")
        for name in ("F3p", "F4", "F5"):
            check(len(set(runs[name]["ks"])) > 1,
                  f"{name}: K never varied: {runs[name]['ks']}")
        for a, b in (("F3p", "F3"), ("F4 sequential twin", "F4")):
            same = {k: runs[a][k] == runs[b][k] for k in
                    ("digest", "accuracy", "aco", "fleet", "metrics")}
            log(f"  {a} against {b}: {same}")
            check(all(same.values()), f"{a} differs from {b}: {same}")
        for name in ("F1", "F2"):
            _, _, runs[f"{name} fault-free"] = fault_run(
                torch, port, ops, data, f"{name} fault-free",
                FAULT_RUNS[name], faulted=False)
        drift = {}
        for tag in ("", " fault-free"):
            drift[tag] = _drift(runs["F1" + tag], runs["F2" + tag])
        (mdiff, adiff), (mfree, afree) = drift[""], drift[" fault-free"]
        log(f"  F1 (batched) against F2 (sequential): max |metric diff| "
            f"{mdiff:.3g}, |ACO diff| {adiff:.3g} (without faults "
            f"{mfree:.3g} and {afree:.3g}); held to {FAULT_METRIC_TOL:g} "
            f"and {FAULT_ACO_TOL:g}")
        check(mdiff < FAULT_METRIC_TOL and adiff < FAULT_ACO_TOL,
              f"F1 and F2 differ: metrics {mdiff}, ACO {adiff}")
        engine_drift = {"faulted": drift[""],
                        "fault_free": drift[" fault-free"],
                        "tolerance": (FAULT_METRIC_TOL, FAULT_ACO_TOL)}
        ckpt = {}
        for name in RESUMED:
            ckpt[name] = resume_run(torch, port, data, name, FAULT_RUNS[name],
                                    tmp / name, runs[name])
        root = tmp / "every5"
        _, _, every = fault_run(torch, port, ops, data, "F3 every 5",
                                FAULT_RUNS["F3"], checkpoint_dir=str(root),
                                checkpoint_every=5)
        written = [r for r, _ in port.fleet_ckpt.checkpoint_dirs(str(root))]
        same = {k: every[k] == runs["F3"][k] for k in
                ("digest", "accuracy", "aco", "fleet", "state")}
        log(f"  F3 with checkpoint_every=5: checkpoints {written}, equal to "
            f"F3: {same}")
        check(written == [5, FAULT_ROUNDS] and all(same.values()),
              f"F3 with checkpoint_every=5: {written}, {same}")
        runs["F3 every 5"] = every
        cpu.wait(timeout=600)
        check(cpu.returncode == 0,
              f"CPU twins failed: {cpu_log.read_text()[-2000:]}")
        twins = json.loads(cpu_out.read_text())
        for name, res in FAULT_RUNS.items():
            ok = twins[name]["trace"] == runs[name]["trace"]
            log(f"  {name} trace against its CPU twin (reduced CNN, "
                f"{twins[name]['seconds']:.1f} s): equal {ok}")
            check(ok, f"{name}: trace differs from its CPU twin's")
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    for res in runs.values():
        res.pop("trace", None)
    return {"rounds": FAULT_ROUNDS, "counts": counts, "runs": runs,
            "engine_drift": engine_drift, "checkpoints": ckpt}


# -- phase 5g: the dense base store ---------------------------------------
# ``base_store="dense"``, the paper's own distribution, on phase 5's model
# and data, DENSE_ROUNDS rounds a run: name -> (engine, wire, error
# feedback, extra config)
DENSE_ROUNDS = 3
DENSE_RUNS = {
    "G1": ("sequential", "csr", False, {}),
    "G2": ("batched", "csr", False, {}),
    "G3": ("batched", "csr_q", True, {}),
    "G4": ("sequential", "dense_masked", False, {}),
    "G5": ("sequential", "csr", False, {"epochs": 2}),
    # tau = 0 forces the four stragglers every round: T = 10 > K = 6
    "G6": ("batched", "csr", False, {"tau": 0}),
}
NO_COMPACTION = ("masked_pseudo_ce", "masked_pseudo_ce_bwd", "staleness_agg")
# G1 against G2 (dropout 0.1) and G1's setting card against CPU (2 rounds,
# dropout 0) are held to the reference's cross-engine criteria, and card
# against CPU also to phase 4's max |diff| <= 1e-3. Read on an H100 before
# they were set: G1 against G2 differ by 0 in the metrics and 2.68e-4 to
# 1.23e-3 in ACO over seeds 0-4 (tools/engine_drift.py --runs G1,G2),
# card against CPU by 3.15e-4 in the parameters, 0 in the metrics and
# 2.77e-4 in ACO (PERF.md section 6)
DENSE_METRIC_TOL, DENSE_ACO_TOL, DENSE_PARAM_TOL = 1e-4, 2e-3, 1e-3
# launches a dense-store round must show exactly, from its K participants
# and T distribution targets: the sequential round encodes each upload and
# each target alone, the batched round the upload stack and the (T, N)
# target stack once each (with EF the residual stack too)
DENSE_PER_ROUND = {
    ("sequential", "csr", False): {"csr_compact": lambda kt: kt[0] + kt[1]},
    ("batched", "csr", False): {"csr_compact": 2},
    ("batched", "csr_q", True): {"csr_quant": 2, "csr_compact": 3},
    ("sequential", "dense_masked", False): {
        "sparse_delta": lambda kt: kt[0] + kt[1]},
}


def dense_run(torch, port, ops, data, name, engine, wire, ef, extra,
              store="dense", rounds=DENSE_ROUNDS):
    """One phase-5g run at full width, the launch counters set to 0 just
    before it and read just after, each kernel of the path held to its
    exact count from every round's K and T (sparse_comm off: no
    compaction kernel at all)."""
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = port.FedS3ATrainer(data, port.FedS3AConfig(
        rounds=rounds, engine=engine, wire_format=wire, error_feedback=ef,
        base_store=store, **extra))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = tr.train()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    by_shape = sorted([*key, c] for key, c in ops.LAUNCHES_BY_SHAPE.items())
    peak = torch.cuda.max_memory_allocated()
    check(tr.engine == engine and tr.dense_store == (store == "dense") and
          port.cnn_param_count(tr.cnn) == N_FULL,
          f"{name} ran {tr.engine}, store {tr.cfg.base_store}")
    m = out["metrics"]
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()),
          f"{name}: metrics out of range: {m}")
    off = extra.get("sparse_comm") is False
    check(out["aco"] == 1.0 if off else 0.0 < out["aco"] < 1.0,
          f"{name}: ACO out of range: {out['aco']}")
    check(bool(torch.isfinite(tr._global_flat).all()),
          f"{name}: non-finite global parameters")
    kt = [(len(l.participants), len(set(l.participants) | set(l.forced)))
          for l in tr.logs]
    if off:
        check_launches(launches, NO_COMPACTION, name)
    else:
        check_launches(launches, PATH_KERNELS[(engine, wire, ef)], name,
                       DENSE_PER_ROUND.get((engine, wire, ef))
                       if store == "dense" else None, kt)
    s_round = (t2 - t1) / rounds
    wire_bytes = tr.comm.payload_bytes / rounds
    log(f"  {name} {path_name(engine, wire, ef)} {store} {extra or ''}: "
        f"(K, T) a round {kt}, {s_round:.3f} s a round (set-up "
        f"{t1 - t0:.3f} s), accuracy {m['accuracy']:.6f}, ACO "
        f"{out['aco']:.6f}, {wire_bytes:.0f} payload B a round, base store "
        f"{tr.base_store_bytes()} B, peak device memory {peak} B; launches "
        f"by shape {by_shape}")
    return tr, {"s_per_round": s_round, "setup_s": t1 - t0,
                "accuracy": m["accuracy"], "metrics": m, "aco": out["aco"],
                "payload_bytes_per_round": wire_bytes,
                "kt": kt, "base_store_bytes": tr.base_store_bytes(),
                "peak_device_bytes": peak, "launches": launches,
                "launches_by_shape": by_shape,
                "versions": tr.base_versions.tolist(),
                "digest": params_digest(port, tr)}


def dense_store(torch, port, ops, paths, held_rows):
    """Phase 5g. G1-G6 (``DENSE_RUNS``) at full width with exact launches
    from each round's K and T, each beside its versioned twin's ACO (phase
    5's run of the same path, or one run here); G0, sparse_comm off on
    each engine, dense against versioned bit for bit (digest, ACO,
    metrics, versions); G1 against G2 on the card; G1's setting for 2
    rounds at dropout 0 on the card against the CPU (phase 4's way);
    every row count the runs launched a kernel with held in phase 3."""
    import numpy as np
    data = port.make_dataset("basic", scale=0.02)
    runs = {}
    for name, (engine, wire, ef, extra) in DENSE_RUNS.items():
        tr, res = dense_run(torch, port, ops, data, name, engine, wire, ef,
                            extra)
        twin = paths.get(path_name(engine, wire, ef)) if not extra else None
        if twin is None:
            _, twin = dense_run(torch, port, ops, data, f"{name} versioned",
                                engine, wire, ef, extra, store="versioned")
        res["versioned_aco"] = twin["aco"]
        res["versioned_accuracy"] = twin["accuracy"]
        log(f"  {name}: ACO {res['aco']:.6f} dense against "
            f"{twin['aco']:.6f} versioned, accuracy {res['accuracy']:.6f} "
            f"against {twin['accuracy']:.6f}")
        runs[name] = res
        del tr
        torch.cuda.empty_cache()
    for engine in ("sequential", "batched"):
        pair = {}
        for store in ("dense", "versioned"):
            _, pair[store] = dense_run(
                torch, port, ops, data, f"G0 {engine} {store}", engine,
                "csr", False, {"sparse_comm": False}, store=store)
        a, b = pair["dense"], pair["versioned"]
        same = {k: a[k] == b[k] for k in ("digest", "aco", "metrics",
                                          "versions", "kt")}
        log(f"  G0 {engine}, sparse_comm off: dense against versioned "
            f"{same}")
        check(all(same.values()), f"G0 {engine}: the dense store differs "
              f"from the versioned one without sparsification: {same}")
        runs[f"G0 {engine}"] = a
        runs[f"G0 {engine} versioned"] = b
    rows = sorted({(kern, r) for res in runs.values()
                   for kern, r, _, _ in res["launches_by_shape"]
                   if kern in ("csr_compact", "csr_quant", "sparse_delta")})
    missing = [x for x in rows if x[1] not in held_rows]
    log(f"  compaction launches by (kernel, rows): {rows}; rows held in "
        f"phase 3: {sorted(held_rows)}")
    check(not missing, f"phase 5g launched {missing} at rows phase 3 did not "
          f"hold")
    mdiff, adiff = _drift(runs["G1"], runs["G2"])
    log(f"  G1 (sequential) against G2 (batched): max |metric diff| "
        f"{mdiff:.3g}, |ACO diff| {adiff:.3g}; held to "
        f"{DENSE_METRIC_TOL:g} and {DENSE_ACO_TOL:g}")
    check(mdiff < DENSE_METRIC_TOL and adiff < DENSE_ACO_TOL,
          f"G1 and G2 differ: metrics {mdiff}, ACO {adiff}")
    cnn = port.CNNConfig(dropout=0.0)
    gen = torch.Generator().manual_seed(0)
    init = port.params_to_numpy(port.init_cnn(cnn, gen))
    g, c = (_trainer_run(torch, port, cnn, init, dev, 2, base_store="dense")
            for dev in ("cuda", "cpu"))
    _same_schedules(g, c, "G1 card vs CPU")
    worst, outside, total = _param_diff(np, g.params, c.params)
    cmdiff, cadiff = _drift(g.out, c.out)
    log(f"  G1 card vs CPU after 2 rounds (dropout 0): max |diff| "
        f"{worst:.3g} ({outside} of {total} outside atol 1e-4 + rtol "
        f"1e-3), max |metric diff| {cmdiff:.3g}, |ACO diff| {cadiff:.3g}; "
        f"held to {DENSE_PARAM_TOL:g}, {DENSE_METRIC_TOL:g} and "
        f"{DENSE_ACO_TOL:g}")
    check(np.array_equal(g.tr.base_versions, c.tr.base_versions),
          "G1 card vs CPU: base versions differ")
    check(worst <= DENSE_PARAM_TOL and cmdiff < DENSE_METRIC_TOL and
          cadiff < DENSE_ACO_TOL, f"G1 card vs CPU: parameters {worst}, "
          f"metrics {cmdiff}, ACO {cadiff}")
    return {"rounds": DENSE_ROUNDS, "runs": runs,
            "g1_vs_g2": {"metric_diff": mdiff, "aco_diff": adiff},
            "card_vs_cpu": {"max_diff": worst, "outside_atol_rtol": outside,
                            "metric_diff": cmdiff, "aco_diff": cadiff,
                            "aco": [g.out["aco"], c.out["aco"]],
                            "accuracy": [g.out["metrics"]["accuracy"],
                                         c.out["metrics"]["accuracy"]]}}


# -- the FL language-model path: phase 3's vocabulary-wide kernels, phase 5h -
LM_ARCH = "qwen2-1.5b"
LM_LAYERS = 4                 # of 28: the (K, N) stacks, ring and Adam
                              # state of all 28 (N = 1.54e9) pass 80 GB
LM_LAYERS_CUT = 2             # if 4 layers run out of memory
LM_V = 151_936
LM_B = 16                     # the client and server batch
LM_DATA = dict(vocab_size=LM_V, seq_len=16, num_classes=8,
               samples_per_client=48, seed=0)
LM_RUN = dict(rounds=3, C=0.6, tau=2, batch_size=LM_B, lr=5e-4, seed=0)
LM_L0_ROUNDS = 2
# L0 departs from L1's setting in two fields, each for what it holds: an
# absolute sparse threshold below every update sends every nonzero element,
# since under p0.2 the Adam + L1 updates tie at the threshold and an ulp
# between card and CPU moved 1.6M of 40M parameters by up to 3.05e-3 (an
# H100 80GB HBM3 at 700 W; PERF.md §6); and a pseudo-label threshold that
# every row passes, so that the wide backward's every row is non-zero
# inside the trainer (at 0.95 the float32 L0 keeps no row)
LM_L0_KW = dict(sparse_threshold=1e-6, threshold=1e-3)
# L0 card vs CPU: phase 4's metric and ACO bounds; the parameters' 1e-3
# does not hold at N = 40M. Adam turns a near-zero gradient (the data term
# about cancelling the L1 term) into a step of up to lr either way, and
# card and CPU round such gradients to either sign: max 1.46e-3 in every
# run, with 8,042-29,782 of 40,077,568 parameters past atol 1e-4 + rtol
# 1e-3 from run to run, metrics equal, ACO 1.9e-7-4.8e-7 apart (an H100
# 80GB HBM3 at 700 W; PERF.md §6). Held at 4 lr and at a 4e-3 share
L0_PARAM_TOL = 4 * LM_RUN["lr"]
L0_OUTSIDE_SHARE = 4e-3
LM_L0_THREADS = 6             # the CPU twin's intra-op threads (of 8 cores)
LM_PEAK_CUT = 70 * 10**9      # L2's peak past 70 GB: cut to 2 layers
# (rows, C) the vocabulary-wide masked_pseudo_ce kernels are held at: a
# client or server batch, six clients' batches at once, one row, an odd
# width (rows not 16-byte aligned), a width whose slices do not fit in
# shared memory (ops.wide_plan(c)["on_chip"] False: read in each pass)
MPCE_WIDE_SHAPES = ((LM_B, LM_V), (6 * LM_B, LM_V), (1, LM_V), (7, 1025),
                    (3, 600_000))
MPCE_WIDE_TIMED = ((LM_B, LM_V), (6 * LM_B, LM_V))


def lm_config(port, layers=LM_LAYERS, **kw):
    import dataclasses
    return dataclasses.replace(port.get_config(LM_ARCH), num_layers=layers,
                               **kw)


def lm_widths(port):
    """The flat N of phase 5h's models: full width at 4 and 2 layers, and
    L0's reduced widths with the full vocabulary."""
    return sorted({lm_n(port, c) for c in (
        lm_config(port), lm_config(port, LM_LAYERS_CUT), l0_config(port))})


def l0_config(port):
    return port.get_config(LM_ARCH).reduced(vocab_size=LM_V,
                                            dtype="float32")


def _wide_logits(torch, bounds, gen, dev, n, c):
    """(n, c) logits: random rows; every other row confident (one logit
    raised 20 above the row's max, so its softmax max passes theta); rows
    1, 8, ... with their maximum tied at the last column; rows 3, 10, ...
    with a new maximum tied across the first slice boundary of ``bounds``
    (``ops.wide_plan(c)["bounds"]``: the last column of slice 0, the first
    of slice 1), and rows 5, 12, ... across the last boundary."""
    x = torch.randn((n, c), generator=gen, device=dev) * 3
    rows = torch.arange(0, n, 2, device=dev)
    cols = torch.randint(0, c, (len(rows),), generator=gen, device=dev)
    x[rows, cols] = x[rows].max(dim=1).values + 20.0
    x[1::7, c - 1] = x[1::7].max(dim=1).values
    for r0, b in ((3, bounds[1][0]), (5, bounds[-1][0])):
        top = x[r0::7].max(dim=1).values + 1.0
        x[r0::7, b - 1] = top
        x[r0::7, b] = top
    return x


def _sum_report(torch, logits, rows):
    """Per row: the float64 sum of exp(x - max) beside its two float32
    roundings (down, up), for a row whose bits differ."""
    out = []
    for r in rows[:4]:
        x = logits[r]
        s64 = float(torch.exp(x - x.max()).double().sum())
        lo = float(torch.tensor(s64, dtype=torch.float64).float())
        hi = lo
        if lo > s64:
            lo = float(torch.nextafter(torch.tensor(lo), torch.tensor(0.0)))
        elif lo < s64:
            hi = float(torch.nextafter(torch.tensor(lo),
                                       torch.tensor(float("inf"))))
        out.append(f"row {r}: float64 sum {s64!r}, float32 roundings "
                   f"{lo!r} / {hi!r}")
    return out


def check_masked_pseudo_ce_wide(torch, ops, ref, dev, gen, flushes):
    """Phase 3, the vocabulary-wide kernels (C > 1024, a cluster a row):
    forward (loss and mask) and backward, through autograd and alone, bit
    for bit against the float64-summed plain versions on the same tensors,
    confident rows and ties across slice boundaries planted; then
    forward alone and backward alone timed at the FL LM's shapes, beside
    the plain versions and the library calls
    (``torch.log_softmax(x).max(1)``, ``torch.softmax``)."""
    fwd, bwd = [], []
    for n, c in MPCE_WIDE_SHAPES:
        logits = _wide_logits(torch, ops.wide_plan(c)["bounds"], gen, dev,
                              n, c)
        g = torch.rand((n,), generator=gen, device=dev)
        loss_k, mask_k, grad_k = _mpce_call(torch, ops.masked_pseudo_ce,
                                            None, logits, g)
        loss_p, mask_p = ref.masked_pseudo_ce_ref(logits, THETA)
        grad_p = ref.masked_pseudo_ce_grad(logits, mask_k, g)
        grad_d = ops.masked_pseudo_ce_grad(logits, mask_k, g)
        torch.cuda.synchronize()
        same = {"loss": _same_bits(torch, loss_k.detach(), loss_p),
                "mask": _same_bits(torch, mask_k, mask_p),
                "grad (autograd)": _same_bits(torch, grad_k, grad_p),
                "grad (alone)": _same_bits(torch, grad_d, grad_p)}
        masked = int(mask_k.sum())
        nonzero = int((grad_d != 0).any(dim=1).sum())
        plan = ops.wide_plan(c)
        log(f"  masked_pseudo_ce ({n}, {c}), a cluster of {plan['cluster']} "
            f"blocks a row, slices of {plan['slice']} columns "
            f"({plan['smem_bytes']} B, on chip {plan['on_chip']}): same "
            f"bits as plain {same}; {masked} of {n} rows masked in, "
            f"{nonzero} gradient rows non-zero")
        if not all(same.values()):
            bad = ((loss_k.detach() != loss_p) | (grad_d != grad_p).any(1)
                   | (grad_k != grad_p).any(1)).nonzero()[:, 0].tolist()
            for line in _sum_report(torch, logits, bad):
                log(f"    {line}")
        check(all(same.values()), f"masked_pseudo_ce ({n}, {c}): the wide "
              f"kernels differ from the plain versions' bits: {same}")
        # both sides of theta where there are two rows (row 0 is confident)
        check((0 < masked < n if n > 1 else masked == 1)
              and nonzero == masked,
              f"masked_pseudo_ce ({n}, {c}): {masked} rows masked in, "
              f"{nonzero} non-zero gradient rows")
        if (n, c) not in MPCE_WIDE_TIMED:
            continue
        mask = mask_k
        fwd.append({"shape": [n, c], "timed": "forward alone", **_timed(
            torch, lambda: ops.masked_pseudo_ce(logits, THETA),
            lambda: ref.masked_pseudo_ce_ref(logits, THETA),
            4 * n * c + 8 * n, 4 * n * c, reps=30, flushes=flushes,
            library=lambda: torch.log_softmax(logits, dim=1).max(dim=1))})
        bwd.append({"shape": [n, c], "timed": "backward alone", **_timed(
            torch, lambda: ops.masked_pseudo_ce_grad(logits, mask, g),
            lambda: ref.masked_pseudo_ce_grad(logits, mask, g),
            8 * n * c + 8 * n, 7 * n * c, reps=30, flushes=flushes,
            library=lambda: torch.softmax(logits, dim=1))})
        for what, sh in (("forward", fwd[-1]), ("backward", bwd[-1])):
            log(f"  masked_pseudo_ce {what} ({n}, {c}): kernel "
                f"{sh['ms']:.5f} ms, plain {sh['plain_ms']:.5f} ms, library "
                f"{sh['library_ms']:.5f} ms, bound {sh['bound_ms']:.5f} ms "
                f"({sh['bound_by']})")
        del logits, g, loss_k, mask_k, grad_k, loss_p, grad_p, grad_d
    return fwd, bwd


def check_lm_width_compaction(torch, ops, ref, comm_mod, port, dev, gen,
                              flushes):
    """Phase 3 at the FL LM's flat widths (phase 5h's N at 4 and 2 layers
    and L0's): ``csr_compact`` at (1, N) and (6, N) bit for bit, the (6, N)
    plain version row by row (rows are independent; the whole (6, N) plain
    version needs past 40 GB), and ``staleness_agg`` at (k, N), k = 1-6
    (the sequential engine's group sums take any k up to K), within rtol
    1e-6 as at the CNN's width. Six rows of 420,566,528 are 2.52e9
    elements, past 2**31. Times at the 4-layer N."""
    shapes = {"csr_compact": [], "staleness_agg": []}
    held = set()
    widths = lm_widths(port)
    n_main = max(widths)
    for n in widths:
        cap = comm_mod.SparseComm("p0.2").payload_capacity(n)
        x6 = torch.randn((6, n), generator=gen, device=dev) * 1e-3
        x6[:, ::10] = 0.0
        thr6 = comm_mod.local_quantile_thresholds(x6, 0.2)
        for k in (1, 6):
            xx, tt = (x6[:1].contiguous(), thr6[:1].contiguous()) if k == 1 \
                else (x6, thr6)
            vk, ik, nk = ops.csr_compact(xx, tt, cap)
            same = True
            for r in range(k):
                vp, ip, np_ = ref.csr_compact2d_ref(xx[r:r + 1], tt[r:r + 1],
                                                    cap)
                same &= torch.equal(vk[r:r + 1], vp) and \
                    torch.equal(ik[r:r + 1], ip) and \
                    torch.equal(nk[r:r + 1], np_)
                del vp, ip, np_
            torch.cuda.synchronize()
            log(f"  csr_compact ({k}, {n}), cap {cap}: nnz {nk.tolist()}, "
                f"bit-exact {same}")
            check(same, f"csr_compact ({k}, {n}): kernel differs from plain")
            held.add(("csr_compact", k, n))
            if n == n_main:
                del vk, ik, nk
                shapes["csr_compact"].append({
                    "shape": [k, n], "case": "FL LM upload / chain advance",
                    "cap": cap, **csr_compact_call(torch, ops, xx, tt, cap,
                                                   flushes),
                    "plain_ms": time_ms(torch, lambda: ref.csr_compact2d_ref(
                        xx[:1], tt[:1], cap), reps=3) * k,
                    "plain_how": "row by row (k calls at (1, N))",
                    "library_ms": None})
        del thr6
        for k in range(1, 7):
            w = torch.rand((k,), generator=gen, device=dev)
            w = w / w.sum()
            d = x6[:k]
            out_k = ops.staleness_agg(d, w)
            out_p = ref.staleness_agg_ref(d, w)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            close = torch.allclose(out_k, out_p, rtol=1e-6, atol=0.0)
            log(f"  staleness_agg ({k}, {n}): max |kernel - plain| {err:.3g}, "
                f"allclose rtol 1e-6: {close}")
            check(close, f"staleness_agg ({k}, {n}) off by {err}")
            held.add(("staleness_agg", k, n))
            del out_k, out_p
            if n == n_main and k in (1, 6):
                shapes["staleness_agg"].append({"shape": [k, n], **_timed(
                    torch, lambda: ops.staleness_agg(d, w),
                    lambda: ref.staleness_agg_ref(d, w),
                    (k + 1) * 4 * n + 4 * k, 2 * k * n, reps=10,
                    plain_reps=3, flushes=flushes,
                    library=lambda: w @ d)})
        del x6, d
        torch.cuda.empty_cache()
    return shapes, held


def _bf16_case_logits(torch, ops, gen, dev, n, c):
    """(n, c) bf16 logits: above ``ops.MPCE_BWD_MAX_C`` classes
    ``_wide_logits``' rows; below, random rows with every other one
    confident and rows 1, 8, ... with their maximum tied at the last
    column. The ties survive the rounding to bf16 (the tied values are
    copies), and no row is planted at theta."""
    if c > ops.MPCE_BWD_MAX_C:
        x = _wide_logits(torch, ops.wide_plan(c)["bounds"], gen, dev, n, c)
    else:
        x = torch.randn((n, c), generator=gen, device=dev) * 3
        rows = torch.arange(0, n, 2, device=dev)
        cols = torch.randint(0, c, (len(rows),), generator=gen, device=dev)
        x[rows, cols] = x[rows].max(dim=1).values + 20.0
        x[1::7, c - 1] = x[1::7].max(dim=1).values
    return x.to(torch.bfloat16)


def check_masked_pseudo_ce_bf16(torch, ops, ref, dev, gen):
    """Phase 3, bf16 logits (cast to float32 once by the wrapper): at
    (16, 151936) (the wide kernels) and (16, 9), forward and backward,
    through autograd and alone, against ``ref.masked_pseudo_ce_ref`` /
    ``ref.masked_pseudo_ce_grad`` on the same bf16 tensors: the gradient
    in bf16, mask and gradient bit for bit, the loss bit for bit on the
    wide kernel and within 1e-6 on the narrow one (its sum order is not
    torch's; phase 3's float32 rule)."""
    for n, c in ((LM_B, LM_V), (LM_B, 9)):
        x = _bf16_case_logits(torch, ops, gen, dev, n, c)
        g = torch.rand((n,), generator=gen, device=dev)
        loss_k, mask_k, grad_k = _mpce_call(torch, ops.masked_pseudo_ce,
                                            None, x, g)
        loss_p, mask_p = ref.masked_pseudo_ce_ref(x, THETA)
        grad_p = ref.masked_pseudo_ce_grad(x, mask_k, g)
        grad_d = ops.masked_pseudo_ce_grad(x, mask_k, g)
        torch.cuda.synchronize()
        err = float((loss_k - loss_p).detach().abs().max())
        wide = c > ops.MPCE_BWD_MAX_C
        same = {"loss": _same_bits(torch, loss_k.detach(), loss_p),
                "mask": _same_bits(torch, mask_k, mask_p),
                "grad (autograd)": _same_bits(torch, grad_k, grad_p),
                "grad (alone)": _same_bits(torch, grad_d, grad_p)}
        masked = int(mask_k.sum())
        dtypes = (grad_k.dtype, grad_d.dtype, loss_k.dtype)
        log(f"  masked_pseudo_ce bf16 ({n}, {c}): same bits as plain "
            f"{same}, max |loss - plain| {err:.3g}; gradient dtypes "
            f"{dtypes[:2]}; {masked} of {n} rows masked in")
        if not wide:
            del same["loss"]
        check(all(same.values()) and err <= 1e-6,
              f"masked_pseudo_ce bf16 ({n}, {c}) differs from the plain "
              f"version: {same}, loss off by {err}")
        check(dtypes == (torch.bfloat16, torch.bfloat16, torch.float32),
              f"masked_pseudo_ce bf16 ({n}, {c}): dtypes {dtypes}")
        check(0 < masked < n, f"masked_pseudo_ce bf16 ({n}, {c}): {masked} "
              "rows masked in")


def check_lm_option_widths(torch, ops, ref, comm_mod, port, dev, gen,
                           flushes):
    """Phase 3 for phase 5j. At the FL LM's 2-layer width N: ``sparse_delta``
    at (6, N) (J1's upload) and (1, N) (its chain advance), top 20%, and
    fp16 ``csr_quant`` at (6, cap) and (1, cap) (J2 quantizes one row at
    a time) on a real ``csr_compact`` payload, cap = N / 2, bit for bit
    against the plain versions row by row (rows are independent; (6, N)
    is 1.96e9 elements, under 2**31), each timed; at J0's width
    (lm-small, its absolute threshold: cap N) every compaction kernel a J0
    run launches at every row count 1-8, back to back (``csr_compact``
    at cap and rcap, ``csr_quant`` int8 and fp16, ``staleness_agg``,
    ``sparse_delta`` top 20% and at explicit thresholds); the narrow
    ``masked_pseudo_ce`` at J0's (16, 512) is held by
    ``check_masked_pseudo_ce``. Returns ({kernel: [timed shape entries]},
    held (kernel, rows, width))."""
    shapes = {"sparse_delta": [], "csr_quant": []}
    held = set()
    n = lm_n(port, lm_config(port, LM_LAYERS_CUT))
    nblk = -(-n // 512)
    x6 = _delta(torch, gen, dev, 6, n)
    for case, xx in (("J1 upload", x6), ("J1 chain advance",
                                         x6[:1].clone())):
        k = xx.shape[0]
        mk, nk, tk = ops.sparse_delta_topfrac(xx, 0.2)
        same = True
        for r in range(k):
            mp, np_ = ref.sparse_delta2d_ref(xx[r:r + 1], tk[r:r + 1])
            same &= _same_bits(torch, mk[r:r + 1], mp) and \
                torch.equal(nk[r:r + 1], np_)
            del mp, np_
        torch.cuda.synchronize()
        log(f"  sparse_delta ({k}, {n}) top 20%: survivors "
            f"{nk.sum(dim=1).tolist()}, bit-exact {same}")
        check(same, f"sparse_delta ({k}, {n}): kernel differs from plain")
        held.add(("sparse_delta", k, n))
        del mk, nk
        shapes["sparse_delta"].append({
            "shape": [k, n], "case": f"FL LM {case} (phase 5j)", **_timed(
                torch, lambda: ops.sparse_delta_batch(xx, tk),
                lambda: ref.sparse_delta2d_ref(xx, tk),
                8 * k * n + 4 * k * nblk + 4 * k, 2 * k * n, reps=10,
                plain_reps=3, flushes=flushes)})
    cap = comm_mod.SparseComm("p0.2").payload_capacity(n)
    v6, i6, s6 = quant_payload(torch, ops, comm_mod, x6, 0.2, cap)
    del x6
    for case, (v, i, s) in (("J2 batched upload", (v6, i6, s6)),
                            ("J2 upload, residual, chain", (
                                v6[:1].clone(), i6[:1].clone(),
                                s6[:1].clone()))):
        k = v.shape[0]
        got = ops.csr_quantize(v, i, s, n, q_dtype="fp16")
        same = [True] * 4
        for r in range(k):
            want = _quant_plain(ref, v[r:r + 1], i[r:r + 1], s[r:r + 1], n,
                                "fp16")
            same = [a and _same_bits(torch, g_[r:r + 1], w)
                    for a, g_, w in zip(same, got, want)]
            del want
        torch.cuda.synchronize()
        log(f"  csr_quant fp16 ({k}, {cap}), n {n}: stored {s.tolist()}, "
            f"bit-exact (q, offsets, counts, scales) {same}")
        check(all(same), f"csr_quant fp16 ({k}, {cap}): kernel differs "
              "from plain")
        check(torch.equal(got[2].sum(dim=1, dtype=torch.int32), s),
              f"csr_quant fp16 ({k}, {cap}): block counts do not sum to "
              "stored")
        held.add(("csr_quant", k, n))
        del got
        sh = {"shape": [k, cap], "n": n, "case": f"FL LM {case} (phase 5j)",
              **csr_quant_call(torch, ops, v, i, s, n, "fp16", flushes),
              "plain_ms": time_ms(torch, lambda: _quant_plain(
                  ref, v[:1], i[:1], s[:1], n, "fp16"), reps=3) * k,
              "plain_how": "row by row (k calls at (1, cap))",
              "library_ms": None}
        check(len(sh["device_op_names"]) == 1 and
              sh["device_ops"] == 1, f"csr_quant fp16 ({k}, {cap}): "
              f"{sh['device_ops']} device ops a call "
              f"({sh['device_op_names']}), not 1")
        shapes["csr_quant"].append(sh)
    del v6, i6, s6
    torch.cuda.empty_cache()
    for name, timed in shapes.items():
        for sh in timed:
            log(f"  {name} {sh['shape']} ({sh['case']}): kernel "
                f"{sh['ms']:.5f} ms (events {sh['event_ms']:.5f}), plain "
                f"{sh['plain_ms']:.5f} ms, bound {sh['bound_ms']:.5f} ms "
                f"({sh['bound_by']}), {sh['bound_ms'] / sh['ms']:.0%} of it")
    # J0's width
    n0 = lm_n(port, j0_config(port))
    thr0 = J0_RUN["sparse_threshold"]
    p = {"nc": n0, "cap": comm_mod.SparseComm(thr0).payload_capacity(n0),
         "rcap": comm_mod.SparseComm(thr0).residual_capacity(n0),
         "keep": 0.2, "rfrac": 0.25}
    calls = []
    for k in J0_KS:
        inp = _chunk_inputs(torch, ref, comm_mod, gen, dev, p, k)
        calls += _chunk_calls(torch, ops, ref, p, inp, "upload") + \
            _chunk_calls(torch, ops, ref, p, inp, "residual")
        top = {}

        def topfrac(x=inp.x, top=top):
            m, c, top["t"] = ops.sparse_delta_topfrac(x, 0.2)
            return m, c

        calls += [(f"sparse_delta top 20% ({k}, {n0})", topfrac,
                   lambda x=inp.x, top=top: ref.sparse_delta2d_ref(
                       x, top["t"])),
                  (f"sparse_delta ({k}, {n0})",
                   lambda x=inp.x, t=inp.thr: ops.sparse_delta_batch(x, t),
                   lambda x=inp.x, t=inp.thr: ref.sparse_delta2d_ref(x, t))]
        held |= {(kern, k, n0) for kern in ("csr_compact", "csr_quant",
                                            "staleness_agg", "sparse_delta")}
    log(f"  J0's N {n0} at K = {list(J0_KS)}: {_hold(torch, calls)} calls "
        "bit-exact")
    # check_masked_pseudo_ce held the Eq. 5 kernels at J0's (16, V)
    c0 = J0_DATA["vocab_size"]
    held |= {(kern, LM_B, c0) for kern in ("masked_pseudo_ce",
                                           "masked_pseudo_ce_bwd")}
    return shapes, held


def lm_run(torch, port, ops, name, cfg, engine, dev, rounds, init=None,
           **extra):
    """One phase-5h run of the FL LM path: the launch counters set to 0
    just before it and read just after; s/round, accuracy, ACO, the rows
    the Eq. 5 mask kept each round, launches by shape and peak device
    memory."""
    import numpy as np
    data = port.make_lm_dataset(10, **LM_DATA)
    kept, mpce = [], ops.masked_pseudo_ce

    def counting(logits, threshold):
        loss, mask = mpce(logits, threshold)
        kept[-1] += mask.sum()
        return loss, mask
    ops.reset_launches()
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = port.FedS3ATrainer(data, port.FedS3AConfig(
        model=cfg, engine=engine, device=dev,
        **dict(LM_RUN, rounds=rounds, **extra)), init_params=init)
    if dev == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    ops.masked_pseudo_ce = counting
    try:
        for _ in range(rounds):
            kept.append(torch.zeros((), device=dev))
            out = tr.train(1)
    finally:
        ops.masked_pseudo_ce = mpce
    m = out["metrics"]
    if dev == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    by_shape = sorted([*key, c] for key, c in ops.LAUNCHES_BY_SHAPE.items())
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    aco = out["aco"]
    check(tr.engine == engine and tr.adapter.kind == "lm",
          f"{name} ran {tr.engine}, {tr.adapter.kind}")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()),
          f"{name}: metrics out of range: {m}")
    if extra.get("sparse_comm", True):
        check(0.0 < aco < (1.0 if "sparse_threshold" not in extra else 2.0),
              f"{name}: ACO out of range: {aco}")
    else:
        check(aco == 1.0, f"{name}: the disabled channel's ACO is {aco}")
    check(bool(torch.isfinite(tr._global_flat).all()),
          f"{name}: non-finite global parameters")
    res = {"s_per_round": (t2 - t1) / rounds, "setup_s": t1 - t0,
           "accuracy": m["accuracy"], "metrics": m, "aco": aco,
           "n_params": int(tr._global_flat.numel()),
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "mask_kept": [int(k) for k in kept], "launches": launches,
           "launches_by_shape": by_shape, "peak_device_bytes": peak,
           "participants": [l.participants for l in tr.logs],
           "fleet": out["fleet"]}
    log(f"  {name} ({engine}, {dev}, {cfg.num_layers} layers, N "
        f"{res['n_params']}, {cfg.dtype}): {res['s_per_round']:.3f} s a "
        f"round (set-up {res['setup_s']:.3f} s), accuracy "
        f"{m['accuracy']:.6f}, ACO {aco:.6f}, rows the mask kept a round "
        f"{res['mask_kept']}, peak device memory {peak} B; launches by shape "
        f"{by_shape}")
    return SimpleNamespace(tr=tr, res=res, out={"metrics": m, "aco": aco})


def l0_init(torch, port):
    """L0's initial weights, drawn on the CPU: the same on card and twin."""
    return port.tree_to_numpy(port.lm.init_params(
        l0_config(port), torch.Generator().manual_seed(0)))


def lm_l0_cpu(out_path):
    """L0's CPU twin, run as a subprocess while the card runs L1 and L2:
    writes the final flat parameters, metrics, ACO, schedule and the rows
    the mask kept to ``out_path`` (.npz)."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer
    from repro_torch.core.sparse_comm import flatten_tree
    from repro_torch.data import make_lm_dataset
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.weights import params_to_numpy, tree_to_numpy
    torch.set_num_threads(LM_L0_THREADS)
    port = SimpleNamespace(get_config=get_config, FedS3AConfig=FedS3AConfig,
                           FedS3ATrainer=FedS3ATrainer, lm=lm,
                           make_lm_dataset=make_lm_dataset,
                           params_to_numpy=params_to_numpy,
                           tree_to_numpy=tree_to_numpy)
    r = lm_run(torch, port, ops, "L0 CPU", l0_config(port), "sequential",
               "cpu", LM_L0_ROUNDS, l0_init(torch, port), **LM_L0_KW)
    np.savez(out_path, flat=flatten_tree(r.tr.global_params).numpy(),
             aco=r.out["aco"], s_per_round=r.res["s_per_round"],
             metrics=json.dumps(r.out["metrics"]),
             participants=json.dumps(r.res["participants"]),
             mask_kept=np.asarray(r.res["mask_kept"]))


def lm_path(torch, port, ops, held):
    """Phase 5h. qwen2-1.5b at every published width (bf16 compute,
    float32 parameters), 4 of 28 layers (2 if the batched engine's peak
    passes ``LM_PEAK_CUT``), federated as a final-token classifier: L2
    batched + csr, L1 sequential + csr, 3 rounds each, each
    held to its launches (the Eq. 5 kernels at (16, V) once each a client
    or server step; csr_compact K + 1 a round sequential, 2 batched); L0,
    L1's setting at reduced widths but the full vocabulary in float32 for 2
    rounds (``LM_L0_KW``), on the card against its CPU twin (a subprocess
    started first) within phase 4's metric and ACO bounds and
    ``L0_PARAM_TOL``. Every (kernel, rows, width) launched must have been
    held in phase 3."""
    # L0's CPU twin runs beside L1 and L2, in a process of its own
    tmp = tempfile.mkdtemp(prefix="chip_smoke_l0_")
    twin_out = os.path.join(tmp, "l0_cpu.npz")
    twin_err = open(os.path.join(tmp, "l0_cpu.err"), "w+")
    twin = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--lm-l0-cpu", twin_out],
                            stdout=subprocess.DEVNULL, stderr=twin_err)
    try:
        return _lm_path_runs(torch, port, ops, held, twin, twin_out,
                             twin_err)
    finally:
        if twin.poll() is None:
            twin.kill()
            twin.wait()
        twin_err.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _lm_try(torch, port, ops, name, layers, engine):
    """``lm_run`` on the card at ``layers`` layers, or None if it ran out
    of memory (its tensors die with the traceback, outside the except)."""
    try:
        return lm_run(torch, port, ops, name, lm_config(port, layers),
                      engine, "cuda", LM_RUN["rounds"])
    except torch.cuda.OutOfMemoryError as e:
        log(f"  {name} ran out of memory at {layers} layers "
            f"({str(e).splitlines()[0]})")
    return None


def _lm_path_runs(torch, port, ops, held, twin, twin_out, twin_err):
    import numpy as np
    runs, layers = {}, LM_LAYERS
    # L2 first: if the batched engine at 4 layers runs out of memory or
    # peaks past LM_PEAK_CUT, both runs are cut to 2 layers
    for name, engine in (("L2", "batched"), ("L1", "sequential")):
        r = _lm_try(torch, port, ops, name, layers, engine)
        if name == "L2" and (r is None or
                             r.res["peak_device_bytes"] > LM_PEAK_CUT):
            runs["L2 at 4 layers"] = {"out_of_memory": True} if r is None \
                else r.res
            peak = "past the card" if r is None else \
                r.res["peak_device_bytes"]
            log(f"  L2 at {layers} layers: peak {peak} B, over "
                f"{LM_PEAK_CUT} B: phase 5h cut to {LM_LAYERS_CUT} layers")
            del r
            torch.cuda.empty_cache()
            layers = LM_LAYERS_CUT
            r = _lm_try(torch, port, ops, name, layers, engine)
        check(r is not None, f"{name} ran out of memory at {layers} layers")
        runs[name] = r.res
        lv = r.res["launches"]
        K = [len(p) for p in r.res["participants"]]
        steps = lv["masked_pseudo_ce"]
        check(steps > 0 and lv["masked_pseudo_ce_bwd"] == steps,
              f"{name}: {steps} forward and {lv['masked_pseudo_ce_bwd']} "
              "backward Eq. 5 launches")
        want = sum(k + 1 for k in K) if engine == "sequential" else \
            2 * len(K)
        check(lv["csr_compact"] == want, f"{name}: csr_compact launched "
              f"{lv['csr_compact']} times, expected {want}")
        check(lv["staleness_agg"] > 0, f"{name}: staleness_agg never ran")
        for k in ("sparse_delta", "csr_quant", "flash_attention"):
            check(lv[k] == 0, f"{name}: {k} launched off its path")
        del r
        torch.cuda.empty_cache()
    card = lm_run(torch, port, ops, "L0", l0_config(port), "sequential",
                  "cuda", LM_L0_ROUNDS, l0_init(torch, port), **LM_L0_KW)
    runs["L0"] = card.res
    twin.wait(timeout=900)
    twin_err.seek(0)
    check(twin.returncode == 0, f"L0's CPU twin failed: "
          f"{twin_err.read()[-2000:]}")
    cpu = np.load(twin_out)
    flat = port.flatten_tree(card.tr.global_params).cpu().numpy()
    worst, outside, total = _param_diff(np, {"flat": flat},
                                        {"flat": cpu["flat"]})
    cpu_m = json.loads(str(cpu["metrics"]))
    mdiff, adiff = _drift(card.out, {"metrics": cpu_m,
                                     "aco": float(cpu["aco"])})
    same_sched = card.res["participants"] == json.loads(
        str(cpu["participants"]))
    same_kept = card.res["mask_kept"] == cpu["mask_kept"].tolist()
    log(f"  L0 card vs CPU: schedules equal {same_sched}, rows kept "
        f"{card.res['mask_kept']} / {cpu['mask_kept'].tolist()}, max |diff| "
        f"{worst:.3g} ({outside} of {total} outside atol 1e-4 + rtol 1e-3), "
        f"max |metric diff| {mdiff:.3g}, |ACO diff| {adiff:.3g}; the CPU "
        f"twin {float(cpu['s_per_round']):.3f} s a round")
    runs["L0"]["card_vs_cpu"] = {
        "max_diff": worst, "outside": outside, "metric_diff": mdiff,
        "aco_diff": adiff, "cpu_aco": float(cpu["aco"]),
        "cpu_s_per_round": float(cpu["s_per_round"])}
    check(same_sched and same_kept, "L0: card and CPU schedules or kept "
          "rows differ")
    check(worst <= L0_PARAM_TOL and outside <= L0_OUTSIDE_SHARE * total
          and mdiff < 1e-4 and adiff < 2e-3,
          f"L0 card vs CPU: parameters {worst} ({outside} of {total} "
          f"outside atol / rtol), metrics {mdiff}, ACO {adiff}")
    del card
    torch.cuda.empty_cache()
    launched = sorted({(kern, rows, width) for name in ("L1", "L2", "L0")
                       for kern, rows, width, _ in
                       runs[name]["launches_by_shape"]})
    missing = [x for x in launched if x not in held]
    log(f"  launched (kernel, rows, width): {launched}")
    check(not missing, f"phase 5h launched {missing}, not held in phase 3")
    return {"layers": layers, "runs": runs}


# -- phase 5i: the chunked, faulted, checkpointed FL language model ---------
# LC: phase 5h's L2 setting on the chunked parameter axis with the example's
# faults (examples/fl_large_model.py: chunks of ceil(N / 6), csr + EF, 5%
# crashes and 5% lost uploads, a 2,000 s deadline, a quorum floor of 1).
# On make_lm_dataset(10, ...) at seed 0 the first crash and the first lost
# upload fire in round 4 (the phase prints the rounds), so LC runs 4
LC_CHUNKS = 6
LC_ROUNDS = 4
LC_SAVE = 3                   # L0c is saved after this many rounds
LC_FAULTS = dict(crash_rate=0.05, upload_loss=0.05)
LC_KW = dict(error_feedback=True, round_deadline=2000.0, quorum_floor=1)
# the participant counts phase 3 holds the chunk kernels at: a full round,
# the chain advance's one row, and a degraded quorum's
LC_KS = (6, 1) + FAULT_KS


def lm_n(port, cfg):
    """The flat N of an LM config: every leaf of its parameter tree."""
    return sum(math.prod(t.shape)
               for t in port.tree_leaves(port.lm.param_template(cfg)))


def lc_extra(port, cfg, **kw):
    """LC's settings beyond ``LM_RUN`` for the LM ``cfg``."""
    return dict(chunk_size=-(-lm_n(port, cfg) // LC_CHUNKS),
                traffic=port.TrafficModel(**LC_FAULTS), **LC_KW, **kw)


def lc_plans(port, comm_mod):
    """{name: chunk plan} of phase 5i's layouts: LC's at 4 and at 2 layers
    (p0.2) and L0c's (its absolute threshold: a payload capacity of the
    chunk's width)."""
    runs = {f"LC at {n} layers": (lm_config(port, n), "p0.2")
            for n in (LM_LAYERS, LM_LAYERS_CUT)}
    runs["L0c"] = (l0_config(port), LM_L0_KW["sparse_threshold"])
    out = {}
    for name, (cfg, thr) in runs.items():
        layout = port.ParamLayout.from_template(
            port.lm.param_template(cfg), lc_extra(port, cfg)["chunk_size"])
        out[name] = comm_mod.SparseComm(thr, layout=layout).chunk_plan()
    return out


def _lc_calls(torch, ops, ref, comm_mod, gen, dev, p, k):
    """One chunk's kernel calls in an LC round at ``k`` participants, with
    their plain versions: the upload compacted at cap, the EF residual at
    rcap, the blend's ``staleness_agg`` (k rows) and the chain advance's
    compaction (one row)."""
    up = _chunk_inputs(torch, ref, comm_mod, gen, dev, p, k)
    chain = _chunk_inputs(torch, ref, comm_mod, gen, dev, p, 1)
    calls = _chunk_calls(torch, ops, ref, p, up, "upload") + \
        _chunk_calls(torch, ops, ref, p, up, "residual") + \
        _chunk_calls(torch, ops, ref, p, chain, "chain")
    return [c for c in calls if not c[0].startswith("csr_quant")]


def check_lm_chunk_widths(torch, ops, ref, comm_mod, port, dev, gen,
                          flushes, plans):
    """Phase 3 at phase 5i's chunk widths (``plans``, from ``lc_plans``):
    ``csr_compact`` (upload at cap, EF residual at rcap, chain advance at
    one row) and ``staleness_agg`` bit for bit at every distinct (width,
    cap) of each plan and every K of ``LC_KS``, each K's calls over the
    plan's widths back to back on one stream, as a round makes them. With ``flushes``, one call of each kernel at each
    distinct width of LC's plans at K = 6 is timed. Returns ({kernel:
    [timed shape entries]}, the set of (kernel, rows, width) held)."""
    held, calls_held = set(), 0
    for name, plan in plans.items():
        widths = {(p["nc"], p["cap"]): p for p in plan}
        for k in LC_KS:
            calls = []
            for p in widths.values():
                calls += _lc_calls(torch, ops, ref, comm_mod, gen, dev, p, k)
                held |= {("csr_compact", k, p["nc"]),
                         ("csr_compact", 1, p["nc"]),
                         ("staleness_agg", k, p["nc"])}
            calls_held += _hold(torch, calls)
            del calls
            torch.cuda.empty_cache()
        log(f"  {name}: chunk (width, cap) {sorted(widths)} at K = "
            f"{list(LC_KS)} bit-exact")
    log(f"  {calls_held} calls bit-exact")
    timed = {"csr_compact": [], "staleness_agg": []}
    if flushes is None:
        return timed, held
    lc = [p for name, plan in plans.items() if name.startswith("LC")
          for p in plan]
    for nc in sorted({p["nc"] for p in lc}):
        p = next(q for q in lc if q["nc"] == nc)
        inp = _chunk_inputs(torch, ref, comm_mod, gen, dev, p, 6)
        x, thr, cap, w = inp.x, inp.thr, p["cap"], inp.w
        timed["csr_compact"].append({
            "shape": [6, nc], "case": "FL LM chunk upload", "cap": cap,
            **csr_compact_call(torch, ops, x, thr, cap, flushes),
            "plain_ms": time_ms(torch, lambda: ref.csr_compact2d_ref(
                x, thr, cap), reps=3, flush=flushes.clean),
            "library_ms": None})
        timed["staleness_agg"].append({
            "shape": [6, nc], "case": "FL LM chunk blend", **_timed(
                torch, lambda: ops.staleness_agg(x, w),
                lambda: ref.staleness_agg_ref(x, w), 7 * 4 * nc + 4 * 6,
                2 * 6 * nc, reps=30, plain_reps=5, flushes=flushes,
                library=lambda: w @ x)})
        del inp, x, thr, w
        torch.cuda.empty_cache()
    for name, shapes in timed.items():
        for sh in shapes:
            log(f"  {name} LM chunk {sh['shape']}: kernel {sh['ms']:.5f} ms "
                f"(events {sh['event_ms']:.5f}), plain {sh['plain_ms']:.5f} "
                f"ms, library {sh['library_ms']}, bound "
                f"{sh['bound_ms']:.6f} ms ({sh['bound_by']}), "
                f"{sh['bound_ms'] / sh['ms']:.0%} of it")
    return timed, held


def lc_expected(plan, tr, steps):
    """The exact launches by (kernel, rows, width) of a chunked LM run with
    EF on csr: each round, at its K participants, every chunk compacts the
    upload and the residuals (K rows) and the chain advance (one row) and
    blends K rows; the Eq. 5 kernels run at (B, V) once a client step
    (``steps``), forward and backward."""
    want = {}

    def add(key, n):
        want[key] = want.get(key, 0) + n
    for log_ in tr.logs:
        k = len(log_.participants)
        for p in plan:
            add(("csr_compact", k, p["nc"]), 2)
            add(("csr_compact", 1, p["nc"]), 1)
            add(("staleness_agg", k, p["nc"]), 1)
    for kern in ("masked_pseudo_ce", "masked_pseudo_ce_bwd"):
        add((kern, LM_B, tr.adapter.num_classes), steps)
    return want


def client_steps(tr):
    """Client steps over a run: each participant's batches, a round."""
    nb = tr.num_batches
    return sum(nb[i] for log_ in tr.logs for i in log_.participants)


def lc_run(torch, port, ops, name, cfg, engine, dev, rounds, init=None,
           **extra):
    """One phase-5i run (``lm_run`` with LC's settings), held to its exact
    launches by shape; with its fault trace and counts, and the
    reference's analytic delta peak."""
    r = lm_run(torch, port, ops, name, cfg, engine, dev, rounds, init,
               **lc_extra(port, cfg, **extra))
    tr = r.tr
    check(tr.chunked and tr.layout.num_chunks > 1,
          f"{name}: not chunked ({tr.layout})")
    r.res.update(trace=fault_trace(tr), counts=fault_counts(tr),
                 chunks=list(tr.layout.sizes),
                 peak_delta_device_bytes=tr.peak_delta_device_bytes())
    if dev == "cuda":
        want = lc_expected(tr.comm.chunk_plan(), tr, client_steps(tr))
        got = {tuple(k): c for *k, c in r.res["launches_by_shape"]}
        check(got == want, f"{name}: launches by shape {sorted(got.items())}"
              f", expected {sorted(want.items())}")
        for kern in ("sparse_delta", "csr_quant", "flash_attention"):
            check(r.res["launches"][kern] == 0,
                  f"{name}: {kern} launched off its path")
    return r


def state_arrays(tr):
    """What ``state_digests`` hashes, as host arrays: two runs whose state
    is too large to hash in a few seconds are compared array by array."""
    out = {"flat": tr._global_flat.cpu().numpy(),
           "ring": tr.store.ring.cpu().numpy(),
           "client_version": tr.store.client_version.copy(),
           "detached": tr.store.detached.copy()}
    if tr.cstore is not None:
        for i, a in enumerate(tr.cstore.state_dict()["arrays"]):
            out[f"residuals {i}"] = a
    return out


def same_arrays(np, a, b):
    """Equal keys, and under each equal dtype, shape and bytes."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and
        np.array_equal(a[k].reshape(-1).view(np.uint8),
                       b[k].reshape(-1).view(np.uint8)) for k in a)


def l0c_cpu(out_path):
    """L0c's CPU twin, run as a subprocess while the card runs LC: writes
    the final flat parameters, metrics, ACO, fault trace and the rows the
    mask kept to ``out_path`` (.npz)."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import TrafficModel
    from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer
    from repro_torch.core.sparse_comm import flatten_tree
    from repro_torch.data import make_lm_dataset
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.tree import leaves as tree_leaves
    from repro_torch.weights import tree_to_numpy
    torch.set_num_threads(LM_L0_THREADS)
    port = SimpleNamespace(get_config=get_config, FedS3AConfig=FedS3AConfig,
                           FedS3ATrainer=FedS3ATrainer, lm=lm,
                           make_lm_dataset=make_lm_dataset,
                           tree_to_numpy=tree_to_numpy,
                           tree_leaves=tree_leaves,
                           TrafficModel=TrafficModel)
    r = lc_run(torch, port, ops, "L0c CPU", l0_config(port), "batched",
               "cpu", LC_ROUNDS, l0_init(torch, port), **LM_L0_KW)
    np.savez(out_path, flat=flatten_tree(r.tr.global_params).numpy(),
             aco=r.out["aco"], s_per_round=r.res["s_per_round"],
             metrics=json.dumps(r.out["metrics"]),
             trace=json.dumps(r.res["trace"]),
             mask_kept=np.asarray(r.res["mask_kept"]))


def l0c_resume(torch, port, whole, root):
    """L0c saved after ``LC_SAVE`` rounds in the background and trained on
    at once (the next round writes the ring and the residuals in place);
    restored onto a fresh trainer, saved again with ``wait=True`` and
    finished; that checkpoint restored onto a third trainer and finished.
    Both finished runs must equal the uninterrupted run ``whole`` bit for
    bit. Returns the checkpoint's bytes and the save, exposure and restore
    seconds."""
    cfg = l0_config(port)
    data = port.make_lm_dataset(10, **LM_DATA)
    init = l0_init(torch, port)

    def trainer():
        return port.FedS3ATrainer(data, port.FedS3AConfig(
            model=cfg, engine="batched", device="cuda",
            **dict(LM_RUN, rounds=LC_ROUNDS, **LM_L0_KW,
                   **lc_extra(port, cfg, checkpoint_dir=str(root)))),
            init_params=init)

    a = trainer()
    a.train(LC_SAVE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.save_checkpoint(wait=False)
    t1 = time.perf_counter()
    a.run_round()
    a._ckpt_drain()
    t2 = time.perf_counter()
    del a
    torch.cuda.empty_cache()
    res = {"exposure_s": t1 - t0, "background_write_s_with_a_round": t2 - t0}
    same = {}
    for name in ("background save", "wait=True save"):
        b = trainer()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        got = b.restore()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        check(got == LC_SAVE, f"L0c restored round {got}, saved {LC_SAVE}")
        if name == "background save":
            res["restore_s"] = t4 - t3
            t5 = time.perf_counter()
            path = b.save_checkpoint(wait=True)
            res["save_s"] = time.perf_counter() - t5
            res["ckpt_bytes"] = _dir_bytes(path)
        out = b.train(LC_ROUNDS - LC_SAVE)
        same[name] = {"state": state_digests(b) == whole["state"],
                      "trace": fault_trace(b) == whole["trace"],
                      "aco": out["aco"] == whole["aco"],
                      "fleet": out["fleet"] == whole["fleet"],
                      "metrics": out["metrics"] == whole["metrics"]}
        del b
        torch.cuda.empty_cache()
    log(f"  L0c resumed at round {LC_SAVE}: checkpoint {res['ckpt_bytes']} B,"
        f" save(wait=True) {res['save_s']:.3f} s, save(wait=False) exposure "
        f"{res['exposure_s'] * 1e3:.2f} ms (its write beside a round "
        f"{res['background_write_s_with_a_round']:.3f} s), restore "
        f"{res['restore_s']:.3f} s; bit-equal to the uninterrupted run: "
        f"{same}")
    check(all(all(v.values()) for v in same.values()),
          f"L0c: a resumed run differs: {same}")
    return dict(res, same=same)


def fl_large_model_cli():
    """F2: ``python -m repro_torch.launch.fl_large_model`` at its defaults
    on the card, as a subprocess: exit 0 and the example's final lines."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for knob in ("EXAMPLES_ROUNDS", "EXAMPLES_LM_CLIENTS",
                 "EXAMPLES_LM_CHUNKS"):
        env.pop(knob, None)
    p = subprocess.run([sys.executable, "-m",
                        "repro_torch.launch.fl_large_model"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    secs = time.perf_counter() - t0
    for line in lines:
        log(f"    [fl_large_model] {line}")
    check(p.returncode == 0, f"F2: fl_large_model exited {p.returncode}: "
          f"{p.stderr[-2000:]}")
    check(len(lines) >= 2 and lines[-2].startswith("final: acc=") and
          lines[-1].startswith("wire layout:"),
          f"F2: no final lines in {lines[-3:]}")
    check(sum(line.startswith("  round ") for line in lines) == 6,
          "F2: not 6 rounds")
    log(f"  F2 fl_large_model: exit 0 in {secs:.1f} s")
    return {"seconds": secs, "final": lines[-2], "layout": lines[-1]}


def start_l0c_twin():
    """L0c's CPU twin (``--lm-l0c-cpu``) in a process of its own, with a
    temporary directory for its output and phase 5i's checkpoints."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lmc_"))
    err = open(tmp / "l0c_cpu.err", "w+")
    out = tmp / "l0c_cpu.npz"
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--lm-l0c-cpu", str(out)],
                            stdout=subprocess.DEVNULL, stderr=err)
    return SimpleNamespace(proc=proc, out=out, err=err, tmp=tmp)


def stop_l0c_twin(twin):
    """Stop the twin if it still runs and remove its directory."""
    if twin.proc.poll() is None:
        twin.proc.kill()
        twin.proc.wait()
    twin.err.close()
    shutil.rmtree(twin.tmp, ignore_errors=True)


def lm_chunked(torch, port, ops, ref, comm_mod, held, twin=None):
    """Phase 5i. LC, qwen2-1.5b at every published width (bf16 compute,
    float32 parameters), 4 of 28 layers (2 if its peak passes
    ``LM_PEAK_CUT``), in ``LC_CHUNKS`` chunks, csr + EF, under the
    example's faults, ``LC_ROUNDS`` rounds on the batched engine; LCs the
    same on the sequential engine, equal to LC bit for bit; each held to
    its exact launches by shape, each followed by one round that reads the
    upload stage's own peak. L0c, L0's model in float32 with LC's settings
    (and ``LM_L0_KW``): on the card against its CPU twin (a subprocess
    started first; ``L0_PARAM_TOL``, traces exact) and resumed from a
    checkpoint bit for bit. F2, the ``fl_large_model`` launcher. Every
    (kernel, rows, width) launched must have been held in phase 3.
    ``twin``: L0c's CPU twin if the caller started it earlier
    (``start_l0c_twin``), else it starts here; it is stopped on return."""
    twin = twin or start_l0c_twin()
    try:
        return _lm_chunked_runs(torch, port, ops, ref, comm_mod, held, twin)
    finally:
        stop_l0c_twin(twin)


def _lc_try(torch, port, ops, name, layers, engine):
    """``lc_run`` on the card at ``layers`` layers, or None if it ran out
    of memory (its tensors die with the traceback, outside the except)."""
    try:
        return lc_run(torch, port, ops, name, lm_config(port, layers),
                      engine, "cuda", LC_ROUNDS)
    except torch.cuda.OutOfMemoryError as e:
        log(f"  {name} ran out of memory at {layers} layers "
            f"({str(e).splitlines()[0]})")
    return None


def _lm_chunked_runs(torch, port, ops, ref, comm_mod, held, twin):
    import numpy as np
    runs, layers, states = {}, LM_LAYERS, {}
    for name, engine in (("LC", "batched"), ("LCs", "sequential")):
        r = _lc_try(torch, port, ops, name, layers, engine)
        if name == "LC" and (r is None or
                             r.res["peak_device_bytes"] > LM_PEAK_CUT):
            runs["LC at 4 layers"] = {"out_of_memory": True} if r is None \
                else r.res
            peak = "past the card" if r is None else \
                r.res["peak_device_bytes"]
            log(f"  LC at {layers} layers: peak {peak} B, over "
                f"{LM_PEAK_CUT} B: phase 5i cut to {LM_LAYERS_CUT} layers")
            del r
            torch.cuda.empty_cache()
            layers = LM_LAYERS_CUT
            r = _lc_try(torch, port, ops, name, layers, engine)
        check(r is not None, f"{name} ran out of memory at {layers} layers")
        states[name] = state_arrays(r.tr)
        r.res["stage_peak_bytes"] = stage_peak(torch, r.tr, "_chunk_upload")
        log(f"  {name}: chunks {r.res['chunks']}, peak device memory "
            f"{r.res['peak_device_bytes']} B, the upload stage's own peak "
            f"{r.res['stage_peak_bytes']} B, the reference's analytic delta "
            f"peak {r.res['peak_delta_device_bytes']} B; fleet "
            f"{r.res['fleet']}")
        runs[name] = r.res
        del r
        torch.cuda.empty_cache()
    lc, lcs = runs["LC"], runs["LCs"]
    first = lc["counts"]["first_round"]
    log(f"  LC: the first crash in round {first['crashes']}, the first lost "
        f"upload in round {first['lost']}")
    check(first["crashes"] is not None and first["lost"] is not None,
          f"LC: no crash or no lost upload in {LC_ROUNDS} rounds")
    same = {k: lc[k] == lcs[k] for k in ("trace", "aco", "metrics",
                                         "mask_kept", "fleet")}
    same["state"] = same_arrays(np, states.pop("LC"), states.pop("LCs"))
    lcs["same_as_LC"] = same
    log(f"  LCs (sequential) against LC (batched), bit for bit: {same}")
    check(all(same.values()), f"LCs differs from LC: {same}")

    card = lc_run(torch, port, ops, "L0c", l0_config(port), "batched",
                  "cuda", LC_ROUNDS, l0_init(torch, port), **LM_L0_KW)
    runs["L0c"] = dict(card.res, state=state_digests(card.tr))
    flat = port.flatten_tree(card.tr.global_params).cpu().numpy()
    del card
    torch.cuda.empty_cache()
    runs["L0c"]["resume"] = l0c_resume(torch, port, runs["L0c"],
                                       twin.tmp / "ckpt")
    shutil.rmtree(twin.tmp / "ckpt", ignore_errors=True)
    f2 = fl_large_model_cli()

    t0 = time.perf_counter()
    twin.proc.wait(timeout=900)
    log(f"  waited {time.perf_counter() - t0:.1f} s for L0c's CPU twin")
    twin.err.seek(0)
    check(twin.proc.returncode == 0, f"L0c's CPU twin failed: "
          f"{twin.err.read()[-2000:]}")
    cpu = np.load(twin.out)
    worst, outside, total = _param_diff(np, {"flat": flat},
                                        {"flat": cpu["flat"]})
    cpu_m = json.loads(str(cpu["metrics"]))
    mdiff, adiff = _drift(runs["L0c"], {"metrics": cpu_m,
                                        "aco": float(cpu["aco"])})
    same_trace = runs["L0c"]["trace"] == json.loads(str(cpu["trace"]))
    same_kept = runs["L0c"]["mask_kept"] == cpu["mask_kept"].tolist()
    log(f"  L0c card vs CPU: fault traces equal {same_trace}, rows kept "
        f"{runs['L0c']['mask_kept']} / {cpu['mask_kept'].tolist()}, max "
        f"|diff| {worst:.3g} ({outside} of {total} outside atol 1e-4 + rtol "
        f"1e-3), max |metric diff| {mdiff:.3g}, |ACO diff| {adiff:.3g}; the "
        f"CPU twin {float(cpu['s_per_round']):.3f} s a round")
    runs["L0c"]["card_vs_cpu"] = {
        "max_diff": worst, "outside": outside, "metric_diff": mdiff,
        "aco_diff": adiff, "cpu_aco": float(cpu["aco"]),
        "cpu_s_per_round": float(cpu["s_per_round"])}
    check(same_trace and same_kept, "L0c: card and CPU fault traces or "
          "kept rows differ")
    check(worst <= L0_PARAM_TOL and outside <= L0_OUTSIDE_SHARE * total
          and mdiff < 1e-4 and adiff < 2e-3,
          f"L0c card vs CPU: parameters {worst} ({outside} of {total} "
          f"outside atol / rtol), metrics {mdiff}, ACO {adiff}")
    launched = sorted({(kern, rows, width) for name in ("LC", "LCs", "L0c")
                       for kern, rows, width, _ in
                       runs[name]["launches_by_shape"]})
    missing = [x for x in launched if x not in held]
    log(f"  launched (kernel, rows, width): {launched}")
    check(not missing, f"phase 5i launched {missing}, not held in phase 3")
    return {"layers": layers, "runs": runs, "fl_large_model": f2}


# -- phase 5j: the FL language model on the other wires and options --------
# J1-J3: phase 5h's setting (LM_DATA, LM_RUN: qwen2-1.5b at every published
# width, bf16 compute, float32 parameters) at LM_LAYERS_CUT layers, run
# there directly (5h's batched run at 4 layers passes LM_PEAK_CUT): J1
# batched + dense_masked, J2 sequential + fp16 csr_q + EF over 2 epochs,
# J3 batched on the disabled channel over 2 epochs
J_RUNS = {
    "J1": ("batched", dict(wire_format="dense_masked")),
    "J2": ("sequential", dict(wire_format="csr_q", q_dtype="fp16",
                              error_feedback=True, epochs=2)),
    "J3": ("batched", dict(sparse_comm=False, epochs=2)),
}
# phase 5h's measured peaks at 2 layers (an H100 80GB HBM3 at 700 W;
# PERF.md section 5), from which each J run's peak is reckoned before it
L2_PEAK_CUT = 57.51e9         # L2, batched + csr
L1_PEAK_CUT = 45.74e9         # L1, sequential + csr
LM_CLIENTS = 10               # make_lm_dataset's M in phase 5h
# J0: the jax-free twin of tests/test_torch_lm_trainer.py's LM_SMALL,
# DATA and RUN (lm-small at V = 512, float32, 8 clients, 2 rounds) with
# the absolute threshold 1e-6 that sends every nonzero element, each
# option on both engines, the card against the CPU in this process, at
# that test's bounds: schedules exact, metrics 1e-4, ACO 2e-3, parameters
# atol 1e-4 / rtol 1e-3 but for at most J0_OUTSIDE of them, each within
# two Adam steps. Unlike the CPU test (port against reference, an outlier
# only over 2 epochs), card against CPU has one on every one-epoch option:
# Adam + L1 walk an embedding entry across zero, where an ulp of its
# gradient picks the step's sign, and card and CPU round the GEMMs apart
# (1 of 213,632 outside, 1.21e-4 to 1.22e-4, in 5 or 6 of the 8 runs in
# each of three runs of the phase; none over 2 epochs; an H100 80GB HBM3
# at 700 W, PERF.md §5). The allowance is that measurement and one more, on every
# option.
J0_MODEL = dict(num_layers=1, d_model=128, d_ff=256, num_heads=2,
                num_kv_heads=1, dtype="float32")
J0_DATA = dict(vocab_size=512, seq_len=16, num_classes=8)
J0_CLIENTS = 8
J0_RUN = dict(rounds=2, batch_size=LM_B, lr=5e-4, seed=0,
              sparse_threshold=1e-6)
J0_OPTIONS = {
    "dense_masked": dict(wire_format="dense_masked"),
    "disabled": dict(sparse_comm=False),
    "fp16 + EF": dict(wire_format="csr_q", q_dtype="fp16",
                      error_feedback=True),
    "epochs 2": dict(epochs=2),
}
J0_OUTSIDE = 2
J0_KS = tuple(range(1, J0_CLIENTS + 1))    # rows phase 3 holds J0's N at


def j0_config(port):
    return port.get_config(LM_ARCH).reduced(**J0_MODEL)


def j_reckoned(comm_mod, name, n):
    """The peak device bytes of J run ``name`` at flat width ``n``,
    reckoned from phase 5h's: J1 and J3 are L2 with its (6, cap) CSR
    payload (a float32 value and an int32 index a slot) given up for the
    (6, n) float32 stack they send (the masked deltas; the dense deltas);
    J2 is L1 with the (M, n) resident EF residual. Epochs add nothing: a
    client's Adam state lives through its epochs only."""
    cap = comm_mod.SparseComm("p0.2").payload_capacity(n)
    if name == "J2":
        return L1_PEAK_CUT + LM_CLIENTS * n * 4
    return L2_PEAK_CUT - 6 * cap * 8 + 6 * n * 4


def j_expected(name, tr, steps):
    """J run ``name``'s exact launches by (kernel, rows, width), and the
    kernels it must launch whose shapes follow k-means (the sequential
    engine's group sums: ``staleness_agg`` at any k <= K). Each round at K
    participants: J1 one ``sparse_delta`` (K, N) upload and one (1, N)
    chain advance, one (K, N) blend; J2 per participant a (1, N) upload
    compaction and its fp16 quantization and a residual compaction, and
    the chain advance's compaction and quantization; J3 one (K, N) blend.
    The Eq. 5 kernels at (B, V) once a client step each way."""
    n = tr._global_flat.numel()
    want = {}

    def add(key, c):
        want[key] = want.get(key, 0) + c
    for log_ in tr.logs:
        k = len(log_.participants)
        if name == "J1":
            add(("sparse_delta", k, n), 1)
            add(("sparse_delta", 1, n), 1)
        if name in ("J1", "J3"):
            add(("staleness_agg", k, n), 1)
        if name == "J2":
            add(("csr_compact", 1, n), 2 * k + 1)
            add(("csr_quant", 1, n), k + 1)
    for kern in ("masked_pseudo_ce", "masked_pseudo_ce_bwd"):
        add((kern, LM_B, tr.adapter.num_classes), steps)
    return want, ("staleness_agg",) if name == "J2" else ()


def j_run(torch, port, ops, comm_mod, name):
    """One J run on the card: the reckoned peak printed before it, the
    measured one after, which must stay under ``LM_PEAK_CUT``; the
    launches held to ``j_expected``."""
    engine, extra = J_RUNS[name]
    cfg = lm_config(port, LM_LAYERS_CUT)
    n = lm_n(port, cfg)
    reckoned = j_reckoned(comm_mod, name, n)
    log(f"  {name} ({engine}, {extra}): peak reckoned {reckoned / 1e9:.2f} "
        f"GB")
    r = lm_run(torch, port, ops, name, cfg, engine, "cuda", LM_RUN["rounds"],
               **extra)
    peak = r.res["peak_device_bytes"]
    r.res.update(reckoned_peak_bytes=reckoned, options=extra)
    log(f"  {name}: peak measured {peak / 1e9:.2f} GB ({peak} B), reckoned "
        f"{reckoned / 1e9:.2f} GB")
    check(peak <= LM_PEAK_CUT, f"{name}: peak {peak} B past {LM_PEAK_CUT} B")
    steps = extra.get("epochs", 1) * client_steps(r.tr)
    want, loose = j_expected(name, r.tr, steps)
    got = {tuple(k): c for *k, c in r.res["launches_by_shape"]}
    exact = {k: c for k, c in got.items() if k[0] not in loose}
    check(exact == want, f"{name}: launches by shape {sorted(got.items())}, "
          f"expected {sorted(want.items())}")
    lv = r.res["launches"]
    for kern in loose:
        check(lv[kern] > 0, f"{name}: {kern} never ran")
    for kern in ("csr_compact", "csr_quant", "sparse_delta",
                 "staleness_agg"):
        if kern not in loose and not any(k[0] == kern for k in want):
            check(lv[kern] == 0, f"{name}: {kern} launched off its path")
    check(lv["flash_attention"] == 0, f"{name}: flash_attention launched")
    return r.res


def j0_init(torch, port):
    """J0's initial LM, drawn on the CPU: the same on card and CPU."""
    return port.tree_to_numpy(port.lm.init_params(
        j0_config(port), torch.Generator().manual_seed(0)))


def j0_run(torch, port, ops, engine, dev, extra):
    """One J0 run from ``j0_init``: (trainer, train() result, launches by
    shape)."""
    ops.reset_launches()
    tr = port.FedS3ATrainer(
        port.make_lm_dataset(J0_CLIENTS, **J0_DATA),
        port.FedS3AConfig(model=j0_config(port), engine=engine, device=dev,
                          **J0_RUN, **extra),
        init_params=j0_init(torch, port))
    out = tr.train()
    if dev == "cuda":
        torch.cuda.synchronize()
    return tr, out, sorted([*k, c] for k, c in ops.LAUNCHES_BY_SHAPE.items())


def j0_card_vs_cpu(torch, port, ops):
    """J0: each of ``J0_OPTIONS`` on both engines on the card and on the
    CPU from the same initial LM (drawn on the CPU), at
    tests/test_torch_lm_trainer.py's bounds; every difference is printed
    before any is held. Returns (results, launched (kernel, rows, width))."""
    import numpy as np
    res, launched, bad = {}, set(), []
    for opt, extra in J0_OPTIONS.items():
        for engine in ("sequential", "batched"):
            what = f"J0 {opt}, {engine}"
            t0 = time.perf_counter()
            card, got, shapes = j0_run(torch, port, ops, engine, "cuda",
                                       extra)
            t1 = time.perf_counter()
            cpu, want, _ = j0_run(torch, port, ops, engine, "cpu", extra)
            t2 = time.perf_counter()
            launched |= {tuple(s[:3]) for s in shapes}
            lv = {}
            for kern, _, _, c in shapes:
                lv[kern] = lv.get(kern, 0) + c
            a = port.flatten_tree(card.global_params).cpu().numpy()
            b = port.flatten_tree(cpu.global_params).numpy()
            check(a.shape == b.shape, f"{what}: card {a.shape} against "
                  f"CPU {b.shape} parameters")
            gap = np.abs(a - b)
            # a NaN compares False: it counts outside
            past = gap[~(gap <= 1e-4 + 1e-3 * np.abs(b))]
            mdiff, adiff = _drift(got, want)
            sched = all(
                (x.participants, x.stalenesses, x.forced, x.time) ==
                (y.participants, y.stalenesses, y.forced, y.time)
                for x, y in zip(card.logs, cpu.logs, strict=True)) and \
                list(card.base_versions) == list(cpu.base_versions)
            steps = extra.get("epochs", 1) * client_steps(card)
            res[what] = {"max_diff": float(gap.max()),
                         "outside": int(past.size), "total": int(gap.size),
                         "metric_diff": mdiff, "aco_diff": adiff,
                         "aco": got["aco"], "schedules_equal": sched,
                         "card_s": t1 - t0, "cpu_s": t2 - t1,
                         "launches": lv, "client_steps": steps}
            log(f"  {what}: card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; "
                f"ACO {got['aco']:.6f} / {want['aco']:.6f}, max |metric "
                f"diff| {mdiff:.3g}, max |diff| {gap.max():.3g} "
                f"({past.size} of {gap.size} outside atol 1e-4 + rtol "
                f"1e-3), schedules equal {sched}; launches {lv}")
            lr2 = 2 * J0_RUN["lr"]
            if not (sched and mdiff < 1e-4 and adiff < 2e-3
                    and past.size <= J0_OUTSIDE and
                    (past.size == 0 or past.max() <= lr2)
                    and got["fleet"] == want["fleet"]):
                bad.append(what)
            uses = {"dense_masked": ("sparse_delta",),
                    "fp16 + EF": ("csr_compact", "csr_quant"),
                    "epochs 2": ("csr_compact",), "disabled": ()}[opt]
            for kern in ("csr_compact", "csr_quant", "sparse_delta"):
                if (lv.get(kern, 0) > 0) != (kern in uses):
                    bad.append(f"{what}: {kern} launched {lv.get(kern, 0)}")
            if not (lv.get("masked_pseudo_ce") == steps ==
                    lv.get("masked_pseudo_ce_bwd")):
                bad.append(f"{what}: Eq. 5 launches {lv}, {steps} steps")
    check(not bad, f"J0 card vs CPU outside the bounds: {bad}")
    return res, launched


def lm_options(torch, port, ops, comm_mod, held):
    """Phase 5j. J1-J3 (``J_RUNS``) on the card, J0 card vs CPU; every
    (kernel, rows, width) launched must have been held in phase 3."""
    runs = {}
    for name in J_RUNS:
        # what an earlier run left in a reference cycle would count in
        # this run's peak: collect it, and print what is still held
        gc.collect()
        torch.cuda.empty_cache()
        held_before = torch.cuda.memory_allocated()
        log(f"  device memory held before {name}: {held_before} B")
        t0 = time.perf_counter()
        runs[name] = dict(j_run(torch, port, ops, comm_mod, name),
                          held_before_bytes=held_before)
        log(f"  {name} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    j0, launched = j0_card_vs_cpu(torch, port, ops)
    log(f"  J0 took {time.perf_counter() - t0:.1f} s")
    launched |= {(kern, rows, width) for r in runs.values()
                 for kern, rows, width, _ in r["launches_by_shape"]}
    launched = sorted(launched)
    missing = [x for x in launched if x not in held]
    log(f"  launched (kernel, rows, width): {launched}")
    check(not missing, f"phase 5j launched {missing}, not held in phase 3")
    return {"layers": LM_LAYERS_CUT, "runs": runs, "j0": j0}


# -- phase 6: serving qwen2-1.5b at full width -----------------------------
SERVE_ARCH = "qwen2-1.5b"
SERVE_PARAMS = 1_543_655_424  # param_count() of the full-width config
SERVE_REQUESTS, SERVE_BUCKET, SERVE_NEW = 8, 2048, 32
# ref against pallas in bf16: the reference's attention rounds its logits
# to bf16 before the softmax, the flash kernel keeps them in float32, so
# the last logits differ by bf16 rounding carried through the layers. On
# the CPU (tests/test_torch_lm.py::test_ref_and_pallas_differ_by_rounding)
# max |diff| / max |logits| is 1.2% at 2 layers and 2.5% at 28 (reduced
# width), 1.3% at full width and 2 layers; the bound is 4x the deepest.
REF_VS_PALLAS_REL = 0.10
F32_CARD_VS_CPU = 1e-4        # last logits, float32, 2 layers at full width


def serve_prompts(np, vocab):
    """SERVE_REQUESTS prompts of 512-2048 random tokens, from numpy's
    default_rng(0)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(512, SERVE_BUCKET + 1, size=SERVE_REQUESTS)
    return [rng.integers(0, vocab, size=int(n)).tolist() for n in lens]


def _last_logits(torch, port, cfg, params, toks, impl):
    with torch.inference_mode():
        w = port.lm.compute_params(cfg, params)
        batch = {"tokens": torch.as_tensor(toks, device=params["embed"].device)}
        last, _ = port.make_prefill_step(cfg, toks.shape[1], impl=impl)(
            w, batch)
    return last.float().cpu()


def serve_full_width(torch, np, port, ops, smi):
    """Serve SERVE_REQUESTS prompts on the full-width qwen2-1.5b (random
    weights from a seeded device generator, bf16 compute) through
    ``serve_batch`` with the flash kernel: once to warm up, once timed,
    each with the launch counters reset just before and read just after:
    one prefill and SERVE_NEW - 1 decode steps must launch
    ``flash_attention`` exactly num_layers times (so no decode step
    launches it) and no other kernel. Then the prefill's last logits with
    ``impl="pallas"`` against ``impl="ref"`` on the card, and a 2-layer
    float32 model of the same width served on the card against the CPU."""
    import dataclasses
    cfg = port.get_config(SERVE_ARCH)
    check(cfg.param_count() == SERVE_PARAMS,
          f"{SERVE_ARCH}: param_count {cfg.param_count()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = port.lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in _leaves(params))
    # the analytic count leaves out the QKV biases and the final norm, as
    # the reference's does
    extra = cfg.num_layers * (cfg.num_heads + 2 * cfg.num_kv_heads) * \
        cfg.resolved_head_dim + cfg.d_model
    check(n == SERVE_PARAMS + extra, f"{SERVE_ARCH} has {n} parameters")
    prompts = serve_prompts(np, cfg.vocab_size)
    lens = [len(p) for p in prompts]
    log(f"  {SERVE_ARCH}: {n} parameters (float32, bf16 compute), init "
        f"{init_s:.2f} s; {SERVE_REQUESTS} prompts of {lens} tokens, bucket "
        f"{SERVE_BUCKET}, max_new {SERVE_NEW}")
    res = None
    for run in ("warm-up", "timed"):
        timings = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        toks = port.serve_batch(cfg, params, prompts, max_new=SERVE_NEW,
                                bucket=SERVE_BUCKET, impl="pallas",
                                timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(toks.shape == (SERVE_REQUESTS, SERVE_NEW)
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"serve: bad continuations {toks.shape}")
        check(launches["flash_attention"] == cfg.num_layers,
              f"serve: flash_attention launched "
              f"{launches['flash_attention']} times in one serve_batch "
              f"(one prefill of {cfg.num_layers} layers and {SERVE_NEW - 1} "
              f"decode steps), expected {cfg.num_layers}")
        check(all(c == 0 for kname, c in launches.items()
                  if kname != "flash_attention"),
              f"serve: kernels off the path launched: {launches}")
        new_tokens = SERVE_REQUESTS * SERVE_NEW
        res = {"arch": SERVE_ARCH, "params": n, "requests": SERVE_REQUESTS,
               "bucket": timings["bucket"], "prompt_lens": lens,
               "max_new": SERVE_NEW, "impl": "pallas",
               "cast_s": timings["cast_s"], "prefill_s": timings["prefill_s"],
               "decode_s_per_token": timings["decode_s"] / (SERVE_NEW - 1),
               "wall_s": wall, "tokens_per_s": new_tokens / wall,
               "peak_mem_bytes": peak, "launches": launches, "gpu": smi}
        log(f"  serve {run} ({smi}): prefill {res['prefill_s']:.4f} s, "
            f"decode {res['decode_s_per_token'] * 1e3:.3f} ms/token step, "
            f"cast {res['cast_s']:.4f} s, wall {wall:.4f} s, "
            f"{res['tokens_per_s']:.1f} new tokens/s, peak memory "
            f"{peak / 2**30:.2f} GiB; launches {launches}")

    from repro_torch.launch.serve import left_pad
    toks = left_pad(prompts, SERVE_BUCKET)
    res.update(_profile_serving(torch, port, cfg, params, toks))
    lp = _last_logits(torch, port, cfg, params, toks, "pallas")
    lr = _last_logits(torch, port, cfg, params, toks, "ref")
    diff, mag = float((lp - lr).abs().max()), float(lr.abs().max())
    agree = int((lp.argmax(-1) == lr.argmax(-1)).sum())
    log(f"  prefill last logits, pallas vs ref on the card: max |diff| "
        f"{diff:.4g} on max |logits| {mag:.4g} ({100 * diff / mag:.2f}%, "
        f"bound {100 * REF_VS_PALLAS_REL:.0f}%), first token equal in "
        f"{agree} of {SERVE_REQUESTS}")
    check(diff <= REF_VS_PALLAS_REL * mag, "serve: pallas and ref prefill "
          f"logits differ by {diff} on {mag}")
    res["ref_vs_pallas"] = {"max_abs_diff": diff, "max_abs_logit": mag,
                            "first_token_equal": agree}
    del params

    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    p_cpu = port.lm.init_params(cfg2, torch.Generator().manual_seed(1))
    p_gpu = port.tree_from_numpy(port.tree_to_numpy(p_cpu), "cuda")
    out, last = {}, {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        t0 = time.perf_counter()
        last[dev] = _last_logits(torch, port, cfg2, p, toks, "pallas")
        out[dev] = port.serve_batch(cfg2, p, prompts, max_new=SERVE_NEW,
                                    bucket=SERVE_BUCKET, impl="pallas")
        log(f"  2-layer float32 model, full width, on {dev}: "
            f"{time.perf_counter() - t0:.2f} s")
    diff = float((last["cuda"] - last["cpu"]).abs().max())
    same = bool(np.array_equal(out["cuda"], out["cpu"]))
    log(f"  2-layer float32, card vs CPU: last logits max |diff| {diff:.3g} "
        f"(bound {F32_CARD_VS_CPU:g}), continuations equal {same}")
    check(diff <= F32_CARD_VS_CPU and same,
          "serve: the float32 model differs between card and CPU")
    res["f32_card_vs_cpu"] = {"max_abs_diff": diff, "tokens_equal": same}
    return res


def _profile_serving(torch, port, cfg, params, toks):
    """One prefill (with the flash kernel) and one decode step of the
    served batch under torch.profiler."""
    out = {}
    with torch.inference_mode():
        w = port.lm.compute_params(cfg, params)
        K = toks.shape[1]
        batch = {"tokens": torch.as_tensor(toks, device="cuda")}
        prefill = port.make_prefill_step(cfg, K + SERVE_NEW, impl="pallas")
        step = port.make_serve_step(cfg)
        last, cache = prefill(w, batch)
        tok = last.argmax(dim=-1)
        state = {}

        def one_prefill():
            state["cache"] = prefill(w, batch)[1]

        def one_step():
            step(w, state["cache"], tok, K)
        out["profiled_prefill"] = profile_round(torch, one_prefill,
                                                "prefill")
        step(w, cache, tok, K)                            # warm the step
        out["profiled_decode_step"] = profile_round(torch, one_step,
                                                    "decode step")
    return out


# -- phase 6b: LM training at full width and full depth --------------------
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_PARAMS = 1_543_714_304  # leaves of the full model: param_count() +
#                               the QKV biases and the final norm
T0_B, T0_S, T0_LAYERS = 2, 1024, 2   # qblk = kblk = 512: a 2 x 2 tile grid
T0_LOSS_REL = 1e-5            # flash against ref, float32
T0_GRAD_REL = 1e-4            # per leaf, relative L2 norm
T0_MB_LOSS_REL = 1e-6         # 2 microbatches against 1
PAST_SHARE = 1e-3             # parameters past atol / rtol (Adam sign flips)
T0_LR = 3e-4
# T0c: tests/test_torch_train_step.py's shape on the card and on the CPU
T0C_MODEL = dict(num_layers=1, d_model=128, d_ff=256, num_heads=2,
                 num_kv_heads=1, dtype="float32")
T0C_B, T0C_S, T0C_BLK, T0C_LR, T0C_STEPS = 4, 32, 16, 1e-3, 2
T0C_LOSS_REL, T0C_ATOL, T0C_RTOL = 1e-5, 1e-4, 1e-3
# T1: the full model through launch/train.py's run_lm (impl="flash")
T1_RUN = dict(batch=8, seq=2048, microbatches=4, lr=3e-4, steps=4, seed=0)
T1_PEAK = 75 * 10**9
# F1: the CLI as subprocesses, the fl run in phase 5's batched + csr setting
F1_SCALE = 0.02
F1_FL = ["fl", "--rounds", "3", "--scale", str(F1_SCALE), "--ckpt-every",
         "1"]
F1_LM = ["lm", "--steps", "2"]


def _grad_rels(torch, a, b):
    return [float(torch.linalg.vector_norm((x - y).double())
                  / torch.linalg.vector_norm(y.double()).clamp_min(1e-30))
            for x, y in zip(a, b)]


def _param_gap(torch, port, new, ref, lr_steps, atol, rtol):
    """(elements past atol / rtol, largest |diff| among them, max |diff|)
    of two parameter trees; fails where an element past atol / rtol is
    more than ``lr_steps`` (2 x lr x steps: Adam steps that flipped sign)
    apart, or where more than PAST_SHARE of the elements are past."""
    past, worst, top, n = 0, 0.0, 0.0, 0
    for a, b in zip(port.tree_leaves(new), port.tree_leaves(ref)):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        d = (a - b).abs()
        off = d > atol + rtol * b.abs()
        past += int(off.sum())
        n += d.numel()
        if off.any():
            worst = max(worst, float(d[off].max()))
        top = max(top, float(d.max()))
    check(worst <= lr_steps, f"parameters {worst} apart past atol / rtol, "
          f"more than Adam sign flips allow ({lr_steps})")
    check(past <= PAST_SHARE * n, f"{past} of {n} parameters past atol "
          f"{atol:g} / rtol {rtol:g}, more than {PAST_SHARE:g} of them")
    return past, worst, top


def train_t0(torch, port, dev="cuda"):
    """T0: the full-width model at 2 layers in float32 on the card:
    lm_loss and its gradients with impl="flash" against impl="ref", then
    one train step with 2 microbatches against 1."""
    cfg = dataclasses.replace(port.get_config(TRAIN_ARCH),
                              num_layers=T0_LAYERS, dtype="float32")
    blocks = port.layers.FLASH_BLOCKS
    check(T0_S % blocks["qblk"] == 0 and T0_S // blocks["qblk"] == 2,
          f"T0 expects a 2 x 2 grid of tiles, blocks {blocks}")
    gen = torch.Generator(device=dev).manual_seed(2)
    params = port.lm.init_params(cfg, gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (T0_B, T0_S),
                                     generator=gen, device=dev)}
    out = {}
    for impl in ("flash", "ref", "flash", "ref"):   # the second pair warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = port.value_and_grad(
            lambda p: port.lm_loss(cfg, p, batch, impl=impl), params)
        torch.cuda.synchronize()
        secs = out.get(impl, (0, 0, []))[2] + [time.perf_counter() - t0]
        out[impl] = (float(loss), grads, secs)
    lf, lr_ = out["flash"][0], out["ref"][0]
    rels = _grad_rels(torch, out["flash"][1], out["ref"][1])
    names = [port.path_name(p) for p, _ in
             port.leaves_with_path(params)]
    worst = max(range(len(rels)), key=rels.__getitem__)
    log(f"  T0 ({cfg.d_model} wide, {T0_LAYERS} layers, V {cfg.vocab_size}, "
        f"float32, TF32 {torch.backends.cuda.matmul.allow_tf32}; B {T0_B}, "
        f"S {T0_S}, blocks {blocks['qblk']} x {blocks['kblk']}): loss flash "
        f"{lf:.7f}, ref {lr_:.7f} (rel {abs(lf - lr_) / abs(lr_):.3g}, bound "
        f"{T0_LOSS_REL:g}); gradients max rel L2 {rels[worst]:.3g} "
        f"({names[worst]}, bound {T0_GRAD_REL:g}); loss and gradients "
        f"(first, warm call) flash {out['flash'][2][0]:.3f}, "
        f"{out['flash'][2][1]:.3f} s, ref {out['ref'][2][0]:.3f}, "
        f"{out['ref'][2][1]:.3f} s")
    check(abs(lf - lr_) <= T0_LOSS_REL * abs(lr_),
          f"T0: flash loss {lf} against ref {lr_}")
    check(max(rels) <= T0_GRAD_REL, f"T0: gradients {rels[worst]} apart "
          f"at {names[worst]}")
    out_s = {impl: out[impl][2] for impl in out}
    del out
    opt = port.adam_init(params)
    res = {}
    for mb in (1, 2):
        step = port.make_train_step(cfg, lr=T0_LR, num_microbatches=mb,
                                    impl="flash")
        res[mb] = step(params, opt, batch)
    l1, l2 = float(res[1][2]), float(res[2][2])
    # Adam's first moment after one step is 0.1 x the gradient: it holds
    # the microbatched sum, which the parameters' sign steps cannot show
    mrels = _grad_rels(torch, port.tree_leaves(res[2][1]["m"]),
                       port.tree_leaves(res[1][1]["m"]))
    mworst = max(range(len(mrels)), key=mrels.__getitem__)
    log(f"  T0 train step, 2 microbatches vs 1: loss {l2:.7f} vs {l1:.7f} "
        f"(rel {abs(l2 - l1) / abs(l1):.3g}, bound {T0_MB_LOSS_REL:g}); "
        f"Adam's m (0.1 x gradient) max rel L2 {mrels[mworst]:.3g} "
        f"({names[mworst]}, bound {T0_GRAD_REL:g})")
    check(abs(l2 - l1) <= T0_MB_LOSS_REL * abs(l1),
          f"T0: microbatched loss {l2} against {l1}")
    check(max(mrels) <= T0_GRAD_REL, f"T0: microbatched gradients "
          f"{mrels[mworst]} apart at {names[mworst]}")
    past, _, top = _param_gap(torch, port, res[2][0], res[1][0],
                              2 * T0_LR, 1e-6, 0.0)
    log(f"  T0 train step parameters: max |diff| {top:.3g} (bound 2 lr = "
        f"{2 * T0_LR:g}), {past} elements past 1e-6 (bound "
        f"{PAST_SHARE:g} of them)")
    return {"loss_flash": lf, "loss_ref": lr_, "grad_rel_max": max(rels),
            "s_flash": out_s["flash"], "s_ref": out_s["ref"],
            "grad_rel_worst_leaf": names[worst], "mb2_loss": l2,
            "mb1_loss": l1, "mb_m_rel_max": max(mrels),
            "mb_param_max_abs_diff": top,
            "mb_params_past_1e-6": past}


def train_t0c(torch, np, port, dev="cuda"):
    """T0c: tests/test_torch_train_step.py's reduced model, T0C_STEPS steps
    of impl="flash" with 2 microbatches, on the card against the CPU from
    the same parameters and tokens."""
    cfg = port.get_config(TRAIN_ARCH).reduced(**T0C_MODEL)
    p_cpu = port.lm.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, cfg.vocab_size, (T0C_B, T0C_S))
            for _ in range(T0C_STEPS)]
    blocks = port.layers.FLASH_BLOCKS
    saved = dict(blocks)
    blocks.update(qblk=T0C_BLK, kblk=T0C_BLK)
    try:
        runs = {}
        for where in (dev, "cpu"):
            p = port.tree_from_numpy(port.tree_to_numpy(p_cpu), where)
            opt = port.adam_init(p)
            step = port.make_train_step(cfg, lr=T0C_LR, num_microbatches=2,
                                        impl="flash")
            losses = []
            for t in toks:
                p, opt, loss = step(p, opt, {"tokens": torch.as_tensor(
                    t, device=where)})
                losses.append(float(loss))
            runs[where] = (p, losses)
    finally:
        blocks.clear()
        blocks.update(saved)
    lc, lh = runs[dev][1], runs["cpu"][1]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    past, worst, top = _param_gap(
        torch, port, runs[dev][0], runs["cpu"][0],
        2 * T0C_LR * T0C_STEPS, T0C_ATOL, T0C_RTOL)
    log(f"  T0c (reduced, d {cfg.d_model}, V {cfg.vocab_size}, float32, "
        f"{T0C_STEPS} flash steps of 2 microbatches) card vs CPU: losses "
        f"{lc} vs {lh} (max rel {rel:.3g}, bound {T0C_LOSS_REL:g}); "
        f"parameters max |diff| {top:.3g}, {past} past atol {T0C_ATOL:g} / "
        f"rtol {T0C_RTOL:g} (Adam sign flips, bound "
        f"{2 * T0C_LR * T0C_STEPS:g}, largest {worst:.3g})")
    check(rel <= T0C_LOSS_REL, f"T0c: card losses {lc} against CPU {lh}")
    return {"losses_card": lc, "losses_cpu": lh, "loss_rel_max": rel,
            "param_max_abs_diff": top, "params_past_atol_rtol": past}


def train_t1(torch, port, smi, dev="cuda"):
    """T1: qwen2-1.5b at every width and all 28 layers (bf16 compute,
    float32 parameters) through ``run_lm(reduced=False)``: a warm-up step,
    then T1_RUN["steps"] - 1 timed ones. Microbatches 8 if 4 run out of
    memory."""
    cfg = port.get_config(TRAIN_ARCH)
    res = None
    for mb in (T1_RUN["microbatches"], 2 * T1_RUN["microbatches"]):
        args = SimpleNamespace(arch=TRAIN_ARCH, reduced=False, device=dev,
                               **dict(T1_RUN, microbatches=mb))
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            res = port.run_lm(args)
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"  T1 with {mb} microbatches ran out of memory ({e}); "
                f"again with {2 * mb}")
            res = None
            torch.cuda.empty_cache()
    check(res is not None, "T1: out of memory at 8 microbatches too")
    peak = torch.cuda.max_memory_allocated()
    n = sum(t.numel() for t in port.tree_leaves(res["params"]))
    check(res["cfg"].num_layers == 28 and n == TRAIN_PARAMS,
          f"T1 trained {res['cfg'].num_layers} layers, {n} parameters")
    B, S, L = args.batch, args.seq, cfg.num_layers
    tokens = B * S
    flops = 6 * n * tokens + 12 * L * B * S * S * cfg.d_model
    steps = []
    for i, (sec, loss) in enumerate(zip(res["seconds"], res["losses"])):
        share = flops / sec / BF16_OPS_PER_S
        steps.append({"step": i, "warm_up": i == 0, "s": sec,
                      "tokens_per_s": tokens / sec, "loss": loss,
                      "model_flop_share": share})
        log(f"  T1 step {i}{' (warm-up)' if i == 0 else ''} ({smi}): "
            f"{sec:.4f} s, {tokens / sec:.1f} tokens/s, loss {loss:.6f}, "
            f"{100 * share:.2f}% of the bf16 peak's model FLOPs "
            f"({flops:.4g} a step)")
    check(all(math.isfinite(x) for x in res["losses"]),
          f"T1: losses {res['losses']}")
    check(peak < T1_PEAK, f"T1: peak device memory {peak} B")
    # the parameters moved: every leaf differs from its initial draw
    init = port.lm.init_params(
        res["cfg"], torch.Generator(device=dev).manual_seed(args.seed))
    same = [port.path_name(p) for (p, a), b in
            zip(port.leaves_with_path(init), port.tree_leaves(res["params"]))
            if torch.equal(a, b)]
    check(not same, f"T1: leaves unchanged by training: {same}")
    del init, res
    timed = steps[1:]
    mean_s = statistics.mean(s["s"] for s in timed)
    log(f"  T1 ({smi}): {n} parameters, {L} layers, batch {B} x {S}, "
        f"{mb} microbatches, lr {args.lr}: timed steps {mean_s:.4f} s on "
        f"average ({tokens / mean_s:.1f} tokens/s), peak device memory "
        f"{peak} B ({peak / 1e9:.2f} GB; bound {T1_PEAK / 1e9:.0f} GB)")
    return {"params": n, "layers": L, "batch": B, "seq": S,
            "microbatches": mb, "lr": args.lr, "steps": steps,
            "flops_per_step": flops, "mean_timed_s": mean_s,
            "peak_mem_bytes": peak, "gpu": smi}


def train_cli(torch, np, port, batched_csr, dev="cuda"):
    """F1: ``python -m repro_torch.launch.train`` in both modes as
    subprocesses on the card; the fl checkpoint loaded into a fresh
    trainer's ``fl_checkpoint_tree`` and held against phase 5's batched +
    csr run, whose configuration the CLI's must equal."""
    cli_cfg = port.FedS3AConfig(rounds=3, C=0.6, tau=2, seed=0, device=dev)
    path5_cfg = port.FedS3AConfig(rounds=3, wire_format="csr",
                                  error_feedback=False,
                                  client_store="resident", device=dev)
    same_cfg = dataclasses.asdict(cli_cfg) == dataclasses.asdict(path5_cfg)
    log(f"  F1: the CLI's fl config equals phase 5's batched + csr: "
        f"{same_cfg} (basic scenario, scale 0.02, seed 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    out = {}
    try:
        ckpt = os.path.join(tmp, "fl.msgpack")
        runs = {}
        for mode, argv in (("fl", F1_FL + ["--ckpt", ckpt]), ("lm", F1_LM)):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m",
                                "repro_torch.launch.train", *argv,
                                "--device", dev],
                               cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=300)
            runs[mode] = r.stdout.strip().splitlines()
            log(f"  F1 {mode} ({time.perf_counter() - t0:.1f} s, exit "
                f"{r.returncode}): " + " | ".join(runs[mode]))
            check(r.returncode == 0, f"F1 {mode} exited {r.returncode}: "
                  f"{r.stderr[-3000:]}")
        fresh = port.FedS3ATrainer(port.make_dataset("basic", scale=F1_SCALE),
                                   cli_cfg)
        # a fresh trainer has taken no round: its participation matrix has
        # no rows yet, the checkpoint's one a round
        like = dict(port.fl_checkpoint_tree(fresh),
                    participation=np.zeros((cli_cfg.rounds, fresh.M)))
        back = port.load_checkpoint(ckpt, like)
        check(back["round"] == cli_cfg.rounds,
              f"F1: checkpoint of round {back['round']}")
        digest = tree_digest(port, back["global_params"])
        final = runs["fl"][-1]
        want = (f"final acc={batched_csr['accuracy']:.4f} "
                f"aco={batched_csr['aco']:.2f}")
        log(f"  F1 checkpoint: round {back['round']}, {os.path.getsize(ckpt)} "
            f"B, global_params digest {digest[:16]} (phase 5 batched + csr "
            f"{batched_csr['digest'][:16]}); CLI's last line {final!r} "
            f"(phase 5 in its format: {want!r})")
        if same_cfg:
            check(digest == batched_csr["digest"],
                  "F1: the CLI's parameters differ from phase 5's batched + "
                  "csr run of the same configuration")
            check(final == want, f"F1: CLI printed {final!r}, phase 5's "
                  f"run gives {want!r}")
        losses = [float(line.split("loss=")[1].split()[0])
                  for line in runs["lm"] if line.startswith("step ")]
        check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
              f"F1 lm: losses {losses}")
        out = {"same_config_as_phase5": same_cfg, "digest": digest,
               "digest_equal": digest == batched_csr["digest"],
               "fl_last_line": final, "lm_losses": losses,
               "ckpt_bytes": os.path.getsize(ckpt)}
        del fresh, like, back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), f"F1: {tmp} left behind")
    return out


def lm_train(torch, np, port, smi, batched_csr):
    """Phase 6b: T0, T0c, T1, F1 (see the module docstring)."""
    t0 = time.perf_counter()
    res = {"t0": train_t0(torch, port)}
    torch.cuda.empty_cache()
    res["t0c"] = train_t0c(torch, np, port)
    torch.cuda.empty_cache()
    res["t1"] = train_t1(torch, port, smi)
    torch.cuda.empty_cache()
    res["f1"] = train_cli(torch, np, port, batched_csr)
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 6b took {res['seconds']:.1f} s")
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def load_port():
    """The entry points the phases drive, imported from ``src/``."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.feds3a_cnn import CNNConfig
    from repro_torch.core import (REFERENCE_CHURN, ParamLayout, TrafficModel,
                                  baselines)
    from repro_torch.core import fleet_ckpt
    from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer
    from repro_torch.core.sparse_comm import flatten_tree
    from repro_torch.data import (make_dataset, make_fleet_dataset,
                                  make_lm_dataset)
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.train import fl_checkpoint_tree, run_lm
    from repro_torch.models import layers, lm
    from repro_torch.models.cnn import cnn_param_count, cnn_template, init_cnn
    from repro_torch.optimizer import adam_init
    from repro_torch.training.steps import (lm_loss, make_prefill_step,
                                            make_serve_step, make_train_step,
                                            value_and_grad)
    from repro_torch.tree import leaves as tree_leaves
    from repro_torch.tree import leaves_with_path, path_name
    from repro_torch.weights import (params_to_numpy, tree_from_numpy,
                                     tree_to_numpy)
    return SimpleNamespace(
        CNNConfig=CNNConfig, FedS3AConfig=FedS3AConfig,
        FedS3ATrainer=FedS3ATrainer, make_dataset=make_dataset,
        make_fleet_dataset=make_fleet_dataset, baselines=baselines,
        cnn_param_count=cnn_param_count, init_cnn=init_cnn,
        ParamLayout=ParamLayout, cnn_template=cnn_template,
        params_to_numpy=params_to_numpy, get_config=get_config, lm=lm,
        serve_batch=serve_batch, make_prefill_step=make_prefill_step,
        make_serve_step=make_serve_step,
        tree_from_numpy=tree_from_numpy, tree_to_numpy=tree_to_numpy,
        REFERENCE_CHURN=REFERENCE_CHURN, TrafficModel=TrafficModel,
        fleet_ckpt=fleet_ckpt,
        make_lm_dataset=make_lm_dataset, tree_leaves=tree_leaves,
        flatten_tree=flatten_tree, layers=layers, lm_loss=lm_loss,
        value_and_grad=value_and_grad, make_train_step=make_train_step,
        adam_init=adam_init, run_lm=run_lm, load_checkpoint=load_checkpoint,
        fl_checkpoint_tree=fl_checkpoint_tree,
        leaves_with_path=leaves_with_path, path_name=path_name)


def _lm_phases(torch, port, ops, ref, comm_mod, lm_held, lmc_held,
               l0c_twin):
    """Phases 5h and 5i, with 5i's CPU twin already running."""
    log(f"phase 5h: the FL language-model path ({LM_ARCH} at full width, "
        f"{LM_LAYERS} of 28 layers, bf16 compute; L0 reduced widths, float32, "
        "card vs CPU)")
    t0 = time.perf_counter()
    lm_res = lm_path(torch, port, ops, lm_held)
    log(f"  phase 5h took {time.perf_counter() - t0:.1f} s")
    log(f"phase 5i: the chunked, faulted, checkpointed FL LM ({LM_ARCH} at "
        f"full width, {LM_LAYERS} layers, {LC_CHUNKS} chunks of ceil(N / "
        f"{LC_CHUNKS}), csr + EF, 5% crashes and lost uploads, "
        f"{LC_ROUNDS} rounds; L0c card vs CPU and resumed; F2 "
        "fl_large_model)")
    t0 = time.perf_counter()
    lmc_res = lm_chunked(torch, port, ops, ref, comm_mod, lmc_held,
                         l0c_twin)
    log(f"  phase 5i took {time.perf_counter() - t0:.1f} s")
    return lm_res, lmc_res


def main():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.exit("chip_smoke: src/repro_torch not found beside this script; "
                 "run it from a checkout of the repository")
    if sys.argv[1:2] == ["--fault-traces"]:
        return cpu_fault_traces(sys.argv[2])
    if sys.argv[1:2] == ["--lm-l0-cpu"]:
        return lm_l0_cpu(sys.argv[2])
    if sys.argv[1:2] == ["--lm-l0c-cpu"]:
        return l0c_cpu(sys.argv[2])
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this smoke test needs "
                 "one GPU")
    from repro_torch.core import sparse_comm as comm_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    import numpy as np
    port = load_port()

    t_start = time.perf_counter()
    log("phase 1: card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 2: build")
    t0 = time.perf_counter()
    out_dir = build.build()
    log(f"  built in {time.perf_counter() - t0:.1f} s into "
        f"{out_dir.relative_to(ROOT)}")
    for name, text in build.build_log.items():
        for line in text.strip().splitlines():
            log(f"  [{name}] {line}")

    log("phase 3: kernels against their plain versions")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flushes = l2_flushes(torch, dev)
    log(f"  L2 flushes: clean {flushes.clean.kernel[:70]}, write "
        f"{flushes.write.kernel[:70]}")
    kernels = [*check_masked_pseudo_ce(torch, ops, ref, dev, gen),
               check_csr_compact(torch, ops, ref, comm_mod, dev, gen,
                                 flushes),
               check_staleness_agg(torch, ops, ref, dev, gen, flushes),
               check_sparse_delta(torch, ops, ref, dev, gen, flushes),
               check_csr_quant(torch, ops, ref, comm_mod, dev, gen, flushes)]
    log("phase 3 (chunks): csr_compact, csr_quant, staleness_agg at the "
        "slice layout's chunk widths")
    for name, shapes in check_chunk_widths(torch, ops, ref, comm_mod, port,
                                           dev, gen, flushes).items():
        next(k for k in kernels if k["name"] == name)["chunk_shapes"] = \
            shapes
    log(f"phase 3 (every K): the FL compaction kernels at K = "
        f"{list(FAULT_KS)}, full width and chunk widths")
    every_k = check_every_k(torch, ops, ref, comm_mod, port, dev, gen)
    log(f"phase 3 (distribution rows): csr_compact, csr_quant, sparse_delta "
        f"at K = {list(DIST_KS)}, full width")
    every_k += check_every_k(torch, ops, ref, comm_mod, port, dev, gen,
                             ks=DIST_KS, chunks=False)
    log(f"phase 3 (FL LM): masked_pseudo_ce above 1024 classes at "
        f"{list(MPCE_WIDE_SHAPES)}; csr_compact and staleness_agg at the FL "
        f"LM's widths {lm_widths(port)}")
    wide_fwd, wide_bwd = check_masked_pseudo_ce_wide(torch, ops, ref, dev,
                                                     gen, flushes)
    kernels[0]["other_shapes"] += wide_fwd
    kernels[1]["other_shapes"] += wide_bwd
    lm_shapes, lm_held = check_lm_width_compaction(
        torch, ops, ref, comm_mod, port, dev, gen, flushes)
    for name, shapes in lm_shapes.items():
        next(k for k in kernels if k["name"] == name)["other_shapes"] += \
            shapes
    lm_held |= {(kern, n, c) for n, c in MPCE_WIDE_SHAPES
                for kern in ("masked_pseudo_ce", "masked_pseudo_ce_bwd")}
    lmc_plans = lc_plans(port, comm_mod)
    log(f"phase 3 (FL LM chunks): csr_compact and staleness_agg at phase "
        f"5i's chunk widths ({', '.join(lmc_plans)}) at K = {list(LC_KS)}")
    lmc_shapes, lmc_held = check_lm_chunk_widths(
        torch, ops, ref, comm_mod, port, dev,
        torch.Generator(device=dev).manual_seed(1), flushes, lmc_plans)
    for name, shapes in lmc_shapes.items():
        next(k for k in kernels if k["name"] == name)["other_shapes"] += \
            shapes
    lmc_held |= {(kern, n, c) for n, c in MPCE_WIDE_SHAPES
                 for kern in ("masked_pseudo_ce", "masked_pseudo_ce_bwd")}
    log("phase 3 (FL LM options): masked_pseudo_ce on bf16 logits; "
        "sparse_delta and fp16 csr_quant at phase 5j's LM width, every "
        "kernel J0 runs at its width")
    check_masked_pseudo_ce_bf16(torch, ops, ref, dev, gen)
    lmo_shapes, lmo_held = check_lm_option_widths(
        torch, ops, ref, comm_mod, port, dev,
        torch.Generator(device=dev).manual_seed(2), flushes)
    for name, shapes in lmo_shapes.items():
        next(k for k in kernels if k["name"] == name)["other_shapes"] += \
            shapes
    lmo_held |= lm_held
    del flushes
    s_serve = max(len(p) for p in serve_prompts(
        np, get_config(SERVE_ARCH).vocab_size))
    kernels.append(check_flash_attention(torch, ops, ref, dev, gen, s_serve))
    kernels[-1].update(flash_build_report(build, out_dir))
    torch.cuda.empty_cache()
    for k in kernels:
        for sh in [k] + k["other_shapes"]:
            per_call = "" if "device_ms" not in sh else (
                f" (a call: device {sh['device_ms']:.5f} ms in "
                f"{sh['device_ops']:g} ops, host {sh['host_ms']:.5f} ms)")
            if "event_ms" in sh:
                per_call += (f"; events {sh['event_ms']:.5f} ms; under the "
                             f"writing flush device "
                             f"{sh['device_ms_write_flush']:.5f} ms, events "
                             f"{sh['event_ms_write_flush']:.5f} ms")
            log(f"  {k['name']} {sh['shape']}: kernel {sh['ms']:.5f} ms"
                f"{per_call}, plain {sh['plain_ms']:.5f} ms, library "
                f"{sh['library_ms']}, bound {sh['bound_ms']:.6f} ms "
                f"({sh['bound_by']})")

    log("phase 4: the sequential engine on the card vs on the CPU (full "
        "width, dropout 0); then batched vs sequential on the card (dropout "
        "0.1)")
    trainer_gpu_vs_cpu(torch, port)
    chunk_parity = chunked_gpu_vs_cpu(torch, port)
    engines_on_card(torch, port)
    log("phase 4c: the baselines on the card vs on the CPU (full width, "
        "dropout 0, scale 0.02, 2 rounds; FedAsync-SSL 8 arrivals)")
    base_parity = baselines_gpu_vs_cpu(torch, port, ops)

    log(f"phase 5: {len(PATHS)} paths (full-width paper CNN, scale 0.02, 3 "
        "rounds each), each profiled for one more round (phase 5b)")
    paths = {}
    for engine, wire, ef in PATHS:
        tr, launches, res = drive_path(torch, port, ops, engine, wire, ef)
        res["launches"] = launches
        res["profiled_round"] = profile_round(torch, tr.run_round)
        paths[path_name(engine, wire, ef)] = res
        del tr
    log(f"phase 5 (paged): {len(PAGED_PATHS)} paths, each paged right after "
        "its resident twin, bit for bit")
    for engine, wire, ef in PAGED_PATHS:
        twins = paged_twins(torch, port, ops, engine, wire, ef)
        if (engine, wire, ef) not in PATHS:
            paths[path_name(engine, wire, ef)] = twins["resident"]
        paths[path_name(engine, wire, ef, "paged")] = twins["paged"]
    log(f"phase 5 (chunked): {len(CHUNK_PATHS)} paths under the slice "
        f"layout, then chunk_size {FLAT_CHUNK_SIZE} against the flat run")
    paths.update(chunked_paths(torch, port, ops, paths["batched+csr"]))
    log("phase 5c: the baselines at full width (dropout 0.1, 3 rounds; "
        "FedAsync-SSL 12 arrivals), beside FedS3A batched + csr "
        f"({paths['batched+csr']['s_per_round']:.3f} s a round, accuracy "
        f"{paths['batched+csr']['accuracy']:.6f}, ACO "
        f"{paths['batched+csr']['aco']:.6f})")
    base = baselines_full_width(torch, port, ops)
    log("phase 5d: the fleet (batched + csr + EF): M = 1,000 at full width "
        "paged vs resident; M = 1,000,000 at the fleet width, paged")
    fleet_res = fleet(torch, port, ops)
    log(f"phase 5f: faults and fleet checkpoints ({FAULT_ROUNDS} faulted "
        "rounds a run at full width, scale 0.02; REFERENCE_CHURN, 5% "
        "corrupt, deadline 700 s, quorum floor 2)")
    fault_res = faults(torch, port, ops)
    for name, res in fault_res["runs"].items():
        paths[f"faults {name}"] = res
    log(f"phase 5g: the dense base store (G0-G6, full width, scale 0.02, "
        f"{DENSE_ROUNDS} rounds a run)")
    t0 = time.perf_counter()
    dense_res = dense_store(torch, port, ops, paths,
                            set(FAULT_KS) | set(DIST_KS))
    log(f"  phase 5g took {time.perf_counter() - t0:.1f} s")
    for name, res in dense_res["runs"].items():
        paths[f"dense {name}"] = res
    # phase 5i's CPU twin starts with 5h: 5h's wall time is the card's, and
    # the twin, 5i's longest part, takes up the host's spare cores
    l0c_twin = start_l0c_twin()
    try:
        lm_res, lmc_res = _lm_phases(torch, port, ops, ref, comm_mod,
                                     lm_held, lmc_held, l0c_twin)
    finally:
        stop_l0c_twin(l0c_twin)
    log(f"phase 5j: the FL LM on the other wires and options ({LM_ARCH} at "
        f"full width, {LM_LAYERS_CUT} layers: J1 batched + dense_masked, J2 "
        "sequential + fp16 csr_q + EF over 2 epochs, J3 batched, disabled "
        "channel, 2 epochs; J0 lm-small card vs CPU)")
    t0 = time.perf_counter()
    lmo_res = lm_options(torch, port, ops, comm_mod, lmo_held)
    log(f"  phase 5j took {time.perf_counter() - t0:.1f} s")
    def launches_by_run(runs, key):
        return {name: sum(c for *kk, c in r.get("launches_by_shape", ())
                          if tuple(kk) == key) for name, r in runs.items()}

    for k in kernels:
        for sh in k["other_shapes"]:
            case = sh.get("case", "")
            key = (k["name"], *sh["shape"])
            if key in lm_held and "chunk" not in case:
                sh["lm_launches"] = launches_by_run(lm_res["runs"], key)
            if "phase 5j" in case:
                # csr_quant counts its launches at (rows, n), not (rows, cap)
                sh["lm_options_launches"] = launches_by_run(
                    lmo_res["runs"],
                    (k["name"], sh["shape"][0], sh.get("n", sh["shape"][1])))
            if "FL LM chunk" in case:
                sh["lm_chunked_launches"] = launches_by_run(lmc_res["runs"],
                                                            key)

    log(f"phase 6: serving {SERVE_ARCH} at full width ({SERVE_REQUESTS} "
        f"requests, bucket {SERVE_BUCKET}, max_new {SERVE_NEW})")
    serve = serve_full_width(torch, np, port, ops, smi)
    paths["serve"] = {"launches": serve["launches"]}
    log(f"phase 6b: training {TRAIN_ARCH} (T0: flash vs ref and "
        f"microbatches, 2 layers, float32; T0c: reduced, card vs CPU; T1: "
        f"full width, all 28 layers, batch {T1_RUN['batch']} x "
        f"{T1_RUN['seq']}; F1: launch/train.py fl and lm)")
    lm_train_res = lm_train(torch, np, port, smi, paths["batched+csr"])

    # launches: the default path's count, or for a kernel off it, that of
    # the first batched path that runs it (sparse_delta: dense_masked;
    # csr_quant: csr_q + EF; flash_attention: serve)
    for k in kernels:
        by_path = {p: r["launches"][k["name"]]
                   for p, r in {**paths, **base}.items()}
        k["launches"] = by_path["batched+csr"] or \
            by_path["batched+dense_masked"] or \
            by_path["batched+csr_q+ef"] or by_path["serve"]
        k["launches_by_path"] = by_path
        for sh in k.get("chunk_shapes", ()):
            sh["launches"] = chunk_launches(k["name"], sh, paths)
            log(f"  {k['name']} chunk width {sh.get('n', sh['shape'][1])}: "
                f"launches by (rows x width) {sh['launches']}")
    del paths["serve"]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "paths": paths, "serve": serve,
                      "baselines": base, "baselines_card_vs_cpu":
                      base_parity, "chunked_card_vs_cpu": chunk_parity,
                      "fleet": fleet_res, "faults": fault_res,
                      "dense_store": dense_res, "every_k_calls": every_k,
                      "lm_path": lm_res, "lm_chunked": lmc_res,
                      "lm_options": lmo_res,
                      "lm_train": lm_train_res,
                      "gpu": smi}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

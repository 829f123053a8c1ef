"""Per-client availability and traffic model for fault-injected fleets.
A copy of ``repro/core/traffic.py``: the same profiles, the same draws in
the same order, so a fault trace replays bit for bit in either package.

The paper's regime (§IV-C) is heterogeneous, resource-constrained IoT
clients — crashes, flaky uplinks and churn are the norm, not the exception.
This module is the *fault source* the :class:`~repro_torch.core.scheduler.
SemiAsyncScheduler` draws from to turn its happy-path timing simulation into
a faulted one:

* **heavy-tailed compute** — each run's latency is scaled by a lognormal
  multiplier with unit mean (``tail_sigma``), so a minority of runs straggle
  far past the paper's linear latency fit while the fleet mean is preserved;
* **crash-mid-run** (``crash_rate``) — the run dies at a uniform point of
  its duration and its upload never exists; the client reboots immediately
  and retries *from its persisted base version* (its on-disk model survives
  the crash), so repeated crashing shows up as emergent staleness and —
  past ``tau`` — as a forced restart, never as scripted behaviour;
* **upload loss** (``upload_loss``) — the run finishes but the payload is
  dropped in transit.  The client, like every uploader, then listens for
  the next global broadcast: it becomes a distribution target of the next
  round but NOT an aggregation participant, and its upload bytes are never
  booked (bytes-on-wire counts deliveries, not encodes);
* **payload corruption** (``corrupt_prob``) — the run finishes and its
  payload *arrives*, but the bytes are malformed (bit flips, truncation).
  The server's wire-integrity validation rejects it and the upload is
  quarantined through the lost-upload path: never aggregated, never
  booked, the client's EF residual retired, the round's ``quarantined``
  count reported in fleet health;
* **leave/rejoin churn** (``mean_online`` / ``mean_offline``, exponential
  session lengths) — a leaving client cancels its in-flight run and its
  server-side error-feedback residual is retired like a forced restart's; a
  rejoining client waits for the next round boundary, where it is either
  served the chain-delta suffix (parked version still inside the
  staleness window) or an explicit full-model resync payload (version
  evicted from the ring — accounted on the wire, not silently free);
* **late joins** (``late_join_frac``) — that fraction of the fleet starts
  the simulation offline and joins mid-run through the same rejoin path.

All draws come from a *dedicated* RNG owned by the scheduler (never the
latency-jitter stream), so enabling faults cannot perturb the fault-free
schedule, and the same ``(profile, seed)`` pair produces the bit-identical
fault trace however many times — and under whichever engine — it is
replayed.  Draw counts per decision are fixed (three uniforms per run fate,
one per duration) so traces stay aligned across profiles that share a seed.
A profile with ``corrupt_prob > 0`` draws one extra uniform per fate — the
corruption axis shifts the stream ONLY when it is enabled, so every
pre-existing trace is untouched.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# crash/loss probabilities are capped below 1: a fleet whose every run
# crashes can never produce an upload, and next_round would (correctly but
# unhelpfully) spin through its event guard — refuse the profile up front
MAX_FAULT_RATE = 0.95


@dataclass(frozen=True)
class TrafficModel:
    """A fault profile. All rates are per-run probabilities; durations are
    seconds of simulated fleet time (the scheduler's clock)."""

    crash_rate: float = 0.0        # P(run crashes mid-run; upload never born)
    upload_loss: float = 0.0       # P(finished run's upload lost in transit)
    corrupt_prob: float = 0.0      # P(delivered payload arrives malformed
                                   # and is quarantined by the server's
                                   # wire-integrity validation)
    tail_sigma: float = 0.0        # lognormal sigma of the latency
                                   # multiplier (0 = deterministic); the
                                   # multiplier has unit MEAN, so the
                                   # paper's latency fit stays the average
    mean_online: float = math.inf  # mean online session before leaving
                                   # (inf = clients never leave)
    mean_offline: float = 600.0    # mean offline stretch before rejoining
    late_join_frac: float = 0.0    # fraction of the fleet starting offline
                                   # (joins mid-simulation via rejoin)

    def __post_init__(self):
        for name in ("crash_rate", "upload_loss", "corrupt_prob"):
            v = getattr(self, name)
            if not 0.0 <= v <= MAX_FAULT_RATE:
                raise ValueError(f"{name} must be in [0, {MAX_FAULT_RATE}] "
                                 f"(got {v}): rates near 1 starve the fleet "
                                 f"of uploads entirely")
        if not 0.0 <= self.late_join_frac <= 1.0:
            raise ValueError(f"late_join_frac must be in [0, 1], got "
                             f"{self.late_join_frac}")
        if self.tail_sigma < 0:
            raise ValueError(f"tail_sigma must be >= 0, got "
                             f"{self.tail_sigma}")
        if self.mean_online <= 0 or self.mean_offline <= 0:
            raise ValueError("mean_online / mean_offline must be positive")

    @property
    def churns(self) -> bool:
        return math.isfinite(self.mean_online)

    # -- draws (rng is the scheduler's dedicated fault stream) --------------
    def latency_multiplier(self, rng) -> float:
        """Unit-mean lognormal straggler factor (heavy right tail)."""
        if self.tail_sigma <= 0:
            return 1.0
        s = self.tail_sigma
        return float(rng.lognormal(-0.5 * s * s, s))

    def run_fate(self, rng):
        """Sample one run's fate at start time.

        Returns ``(fate, frac)`` with fate in {"ok", "crash", "lost",
        "corrupt"} and ``frac`` the fraction of the run's duration survived
        before a crash (meaningful only when fate == "crash").  Always
        exactly three uniforms — plus one more iff ``corrupt_prob > 0`` —
        so the stream stays aligned across outcomes, and enabling the
        corruption axis is the only thing that can shift it.
        """
        u_crash, u_loss, frac = rng.random(), rng.random(), rng.random()
        u_corrupt = rng.random() if self.corrupt_prob > 0 else 1.0
        if u_crash < self.crash_rate:
            return "crash", float(frac)
        if u_loss < self.upload_loss:
            return "lost", float(frac)
        if u_corrupt < self.corrupt_prob:
            return "corrupt", float(frac)
        return "ok", float(frac)

    def online_duration(self, rng) -> float:
        if not self.churns:
            return math.inf
        return float(rng.exponential(self.mean_online))

    def offline_duration(self, rng) -> float:
        return float(rng.exponential(self.mean_offline))

    def initial_offline(self, rng, M):
        """Sorted client ids starting the simulation offline (late joins)."""
        if self.late_join_frac <= 0:
            return []
        mask = rng.random(M) < self.late_join_frac
        return [int(i) for i in mask.nonzero()[0]]


# The reference churn profile: the fault regime the acceptance scenario,
# the chaos suite's cross-engine runs and the ``bench_fleet --faults``
# cells all share. Crash and loss rates follow the acceptance scenario's
# numbers; the churn means are chosen relative to the paper's measured
# 166–317 s client latencies so a typical client stays online for a
# handful of rounds and an exponential-tail offline stretch occasionally
# outlives the tau+2 ring window (exercising the full-model resync path).
REFERENCE_CHURN = TrafficModel(
    crash_rate=0.10,
    upload_loss=0.05,
    tail_sigma=0.5,
    mean_online=2500.0,
    mean_offline=500.0,
    late_join_frac=0.1,
)

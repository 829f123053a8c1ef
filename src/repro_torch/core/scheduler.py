"""Event-driven semi-asynchronous scheduler (§IV-C), with fault injection.

Deterministically simulates the paper's timing behaviour: each client's
per-round training latency follows the paper's own measurements (§V-D3:
C0 |D|=78357 -> 317 s, C9 |D|=16904 -> 166 s), i.e.

    t_i = 124.47 + 0.0024571 * |D_i|   seconds (+ optional jitter)

The server aggregates as soon as ceil(C*M) uploads are queued
(semi-asynchronous model update); clients that are still training keep
running on their stale base version (staleness-tolerant distribution) unless
their version gap exceeds tau, in which case they are forced to restart from
the new global model (deprecated). ART (average round time) falls out of the
simulated clock, reproducing Table VIII.

Fault injection (``traffic=``, a
:class:`~repro_torch.core.traffic.TrafficModel`)
drives the unhappy paths through the same event loop: heavy-tailed run
latencies, crash-mid-run (the run dies and the client retries from its
persisted base — staleness emerges instead of being scripted), upload loss
(the run finishes but the payload never arrives: the client becomes a
distribution target of the next round, not a participant), leave/rejoin
churn (an in-flight run is cancelled at leave; a rejoiner waits for the
next boundary to be re-based) and late joins.  Churn transitions live in
their own event heap merged with the run heap at pop time, so the run heap
keeps its legacy ``(finish_time, seq, run)`` layout.

Graceful degradation: with a ``deadline`` (seconds of simulated time per
round), a round that cannot gather ``k = ceil(C*M)`` uploads in time
aggregates a *degraded quorum* — whatever arrived, down to
``quorum_floor`` — instead of blocking forever, and reports the
degradation in the round result.  When fewer than the quorum floor of
uploads can ever arrive (no live runs left — fleet churned out or crashed
dry), :meth:`next_round` raises :class:`FleetStalledError` instead of the
bare ``heapq`` ``IndexError`` / infinite loop the happy-path loop had.

``next_round`` returns a :class:`RoundResult`; legacy callers that unpack
``participants, stale, forced, t`` keep working (the result iterates as
that 4-tuple), while the fault-aware trainer reads the extra fields
(``lost``, ``departed``, ``rejoined``, ``degraded``, ``quorum``, ...).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

A_LAT = 124.47
B_LAT = 0.0024571

# hard per-round event budget: a pathological fault profile (e.g. every
# client stuck in a crash-retry loop) must surface as a clear error, not a
# hang — next_round processes at most this many events before declaring
# the fleet stalled
MAX_EVENTS_PER_ROUND = 100_000


def paper_latency(n_samples: int) -> float:
    return A_LAT + B_LAT * n_samples


class FleetStalledError(RuntimeError):
    """The fleet cannot reach the quorum floor: fewer than ``quorum_floor``
    uploads can still arrive (no live runs left, or the per-round event
    budget was exhausted by unproductive events)."""


@dataclass
class ClientRun:
    client: int
    base_version: int      # global round the client's base model came from
    finish_time: float     # upload arrival (or crash) instant
    fate: str = "ok"       # "ok" | "crash" | "lost" | "corrupt" —
                           # sampled at start


@dataclass
class RoundResult:
    """One aggregation boundary. Iterates as the legacy 4-tuple
    ``(participants, stale, forced, time)``; the fault-aware fields ride
    along as attributes."""

    participants: list     # delivered ClientRuns, arrival order
    stale: dict            # client -> rounds stale at aggregation
    forced: list           # clients force-restarted (version gap > tau)
    time: float            # simulated clock at aggregation
    lost: list = field(default_factory=list)      # uploads lost in transit
    corrupted: list = field(default_factory=list)  # uploads that arrived
                                                   # malformed and were
                                                   # quarantined
    departed: list = field(default_factory=list)  # clients that left
    rejoined: list = field(default_factory=list)  # clients back online
    resynced: list = field(default_factory=list)  # filled by the trainer:
                                                  # rejoiners needing a
                                                  # full-model resync
    crashes: int = 0       # crash-mid-run events this round
    degraded: bool = False     # aggregated below the k target
    deadline_hit: bool = False  # the round deadline forced the aggregation
    quorum: int = 0        # delivered uploads actually aggregated
    target_k: int = 0      # the participation threshold k

    def __iter__(self):
        return iter((self.participants, self.stale, self.forced, self.time))


@dataclass
class SchedulerState:
    time: float = 0.0
    round: int = 0
    runs: list = field(default_factory=list)          # heap of (t, seq, run)
    events: list = field(default_factory=list)        # heap of churn
                                                      # (t, seq, kind, client)
    versions: dict = field(default_factory=dict)      # client -> base version
    online: dict = field(default_factory=dict)        # client -> available?
    run_seq: dict = field(default_factory=dict)       # client -> live run seq
    cancelled: set = field(default_factory=set)       # seqs of cancelled runs
    live_runs: int = 0
    # per-round scratch, drained at each boundary
    pending_lost: list = field(default_factory=list)
    pending_corrupt: list = field(default_factory=list)
    pending_rejoin: set = field(default_factory=set)
    pending_departed: list = field(default_factory=list)
    _seq: int = 0


class SemiAsyncScheduler:
    """Drives the FedS3A timing loop; the trainer plugs in the learning."""

    def __init__(self, latencies, *, C=0.6, tau=2, jitter=0.0, seed=0,
                 traffic=None, deadline=None, quorum_floor=1,
                 max_events_per_round=MAX_EVENTS_PER_ROUND):
        self.latencies = list(latencies)
        self.M = len(self.latencies)
        self.k = max(int(math.ceil(C * self.M)), 1)
        self.tau = tau
        self.jitter = jitter
        self.traffic = traffic
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be positive, got {deadline}")
        self.deadline = deadline
        if not 1 <= int(quorum_floor) <= self.k:
            raise ValueError(f"quorum_floor must be in [1, k={self.k}], "
                             f"got {quorum_floor}")
        self.quorum_floor = int(quorum_floor)
        self.max_events_per_round = max_events_per_round
        import numpy as np
        self._rng = np.random.default_rng(seed)
        # faults draw from their own stream so enabling them never perturbs
        # the fault-free schedule (the jitter rng is untouched)
        self._traffic_rng = np.random.default_rng((seed, 0x7a11))
        self.state = SchedulerState()
        st = self.state
        self.initial_offline = traffic.initial_offline(
            self._traffic_rng, self.M) if traffic is not None else []
        offline = set(self.initial_offline)
        for i in range(self.M):
            st.versions[i] = 0
            st.online[i] = i not in offline
            if st.online[i]:
                self._start_run(i, 0, st.time)
                self._schedule_leave(i, st.time)
            else:
                self._schedule_join(i, st.time)

    # -- event construction ------------------------------------------------
    def _lat(self, i):
        if self.jitter:
            return self.latencies[i] * float(
                self._rng.uniform(1 - self.jitter, 1 + self.jitter))
        return self.latencies[i]

    def _start_run(self, client, base_version, start_time):
        st = self.state
        lat = self._lat(client)
        fate = "ok"
        if self.traffic is not None:
            lat *= self.traffic.latency_multiplier(self._traffic_rng)
            fate, frac = self.traffic.run_fate(self._traffic_rng)
            if fate == "crash":
                # the run dies partway through; the upload is never born
                lat *= max(frac, 1e-6)
        run = ClientRun(client, base_version, start_time + lat, fate)
        heapq.heappush(st.runs, (run.finish_time, st._seq, run))
        st.run_seq[client] = st._seq
        st._seq += 1
        st.live_runs += 1

    def _cancel_run(self, client):
        """Cancel the client's in-flight run (lazily: the heap entry is
        skipped when popped / purged at the next forced scan)."""
        st = self.state
        seq = st.run_seq.pop(client, None)
        if seq is not None:
            st.cancelled.add(seq)
            st.live_runs -= 1

    def _schedule_leave(self, client, now):
        if self.traffic is None or not self.traffic.churns:
            return
        st = self.state
        dur = self.traffic.online_duration(self._traffic_rng)
        if math.isfinite(dur):
            heapq.heappush(st.events, (now + dur, st._seq, "leave", client))
            st._seq += 1

    def _schedule_join(self, client, now):
        st = self.state
        dur = self.traffic.offline_duration(self._traffic_rng)
        heapq.heappush(st.events, (now + dur, st._seq, "join", client))
        st._seq += 1

    # -- event processing --------------------------------------------------
    def _process_churn(self, kind, client, t):
        st = self.state
        if kind == "leave":
            if not st.online[client]:
                return
            st.online[client] = False
            self._cancel_run(client)
            if client in st.pending_rejoin:
                # joined and left again between boundaries: it never
                # re-attached, so there is nothing to retire
                st.pending_rejoin.discard(client)
            else:
                st.pending_departed.append(client)
            if client in st.pending_lost:
                st.pending_lost.remove(client)
            if client in st.pending_corrupt:
                st.pending_corrupt.remove(client)
            self._schedule_join(client, t)
        else:  # join
            if st.online[client]:
                return
            st.online[client] = True
            st.pending_rejoin.add(client)
            self._schedule_leave(client, t)

    def next_round(self):
        """Advance until k uploads arrive — or the deadline passes with at
        least ``quorum_floor`` of them (degraded round). Returns a
        :class:`RoundResult` (legacy callers unpack it as
        ``participants, stale, forced, time``).

        Raises :class:`FleetStalledError` when fewer than the quorum floor
        of uploads can still arrive: no live runs remain (the fleet
        churned out, crashed dry, or ``k`` exceeds the online fleet) or
        the per-round event budget is exhausted.
        """
        st = self.state
        deadline_t = (st.time + self.deadline) if self.deadline is not None \
            else math.inf
        arrivals = []
        crashes = 0
        degraded = deadline_hit = False
        processed = 0
        while len(arrivals) < self.k:
            t_run = st.runs[0][0] if st.runs else math.inf
            t_ev = st.events[0][0] if st.events else math.inf
            t_next = min(t_run, t_ev)
            if len(arrivals) >= self.quorum_floor and t_next > deadline_t:
                # deadline passed before the k-th upload: aggregate the
                # degraded quorum at the deadline instant
                degraded = deadline_hit = True
                st.time = max(st.time, deadline_t)
                break
            if st.live_runs == 0:
                # nothing in flight can ever produce another upload
                if len(arrivals) >= self.quorum_floor:
                    degraded = True
                    break
                raise FleetStalledError(
                    f"fleet stalled at t={st.time:.1f}s: {len(arrivals)} "
                    f"upload(s) arrived, quorum floor is "
                    f"{self.quorum_floor} (k={self.k}) and no runs are in "
                    f"flight — every remaining client is offline or dead")
            processed += 1
            if processed > self.max_events_per_round:
                raise FleetStalledError(
                    f"fleet stalled: {self.max_events_per_round} events "
                    f"processed without reaching the quorum floor "
                    f"({len(arrivals)}/{self.quorum_floor} uploads) — "
                    f"the fault profile starves the fleet of uploads")
            if t_ev <= t_run:
                t, _, kind, client = heapq.heappop(st.events)
                st.time = max(st.time, t)
                self._process_churn(kind, client, t)
                continue
            t, seq, run = heapq.heappop(st.runs)
            if seq in st.cancelled:
                st.cancelled.discard(seq)
                continue
            st.time = max(st.time, t)
            st.run_seq.pop(run.client, None)
            st.live_runs -= 1
            if run.fate == "crash":
                # reboot and retry from the persisted base: staleness (and
                # eventually tau-forcing) emerges from the lost time
                crashes += 1
                self._start_run(run.client, run.base_version, st.time)
            elif run.fate == "lost":
                # the upload evaporated in transit; the client waits for
                # the next broadcast like any other uploader
                st.pending_lost.append(run.client)
            elif run.fate == "corrupt":
                # the payload arrived malformed; the server's wire
                # validation quarantines it and the client — like a lost
                # uploader — waits for the next broadcast
                st.pending_corrupt.append(run.client)
            else:
                arrivals.append(run)

        participants = arrivals
        round_idx = st.round

        stale = {run.client: round_idx - run.base_version
                 for run in participants}
        new_version = round_idx + 1

        # distribution: delivered clients still online restart from the new
        # model (a participant that left after uploading stays aggregated
        # but gets no new run)
        for run in participants:
            if st.online[run.client]:
                st.versions[run.client] = new_version
                self._start_run(run.client, new_version, st.time)

        # staleness-tolerant distribution for everyone still training;
        # purge cancelled heap entries while scanning
        forced = []
        kept = []
        changed = False
        for (t, seq, run) in st.runs:
            if seq in st.cancelled:
                st.cancelled.discard(seq)
                changed = True
                continue
            gap = new_version - run.base_version
            if gap > self.tau:
                forced.append(run)
                changed = True
            else:
                kept.append((t, seq, run))
        if changed:
            st.runs = kept
            heapq.heapify(st.runs)
            for run in forced:
                st.run_seq.pop(run.client, None)
                st.live_runs -= 1
                st.versions[run.client] = new_version
                self._start_run(run.client, new_version, st.time)

        # lost-upload clients receive the broadcast and start over;
        # quarantined uploaders follow the identical path (their payload
        # arrived but was rejected, so from the model's point of view it
        # was never delivered)
        lost = sorted(st.pending_lost)
        corrupted = sorted(st.pending_corrupt)
        for c in lost + corrupted:
            st.versions[c] = new_version
            self._start_run(c, new_version, st.time)

        # rejoiners re-base at the boundary (chain suffix or full resync —
        # the trainer's store decides) and start their first new run. A
        # participant that departed and rejoined within the round was
        # already restarted by the participants loop (it is back online) —
        # the run_seq guard keeps it from getting a second run.
        rejoined = sorted(st.pending_rejoin)
        for c in rejoined:
            if c not in st.run_seq:
                st.versions[c] = new_version
                self._start_run(c, new_version, st.time)

        departed = sorted(set(st.pending_departed))
        st.pending_lost = []
        st.pending_corrupt = []
        st.pending_rejoin = set()
        st.pending_departed = []

        st.round = new_version
        return RoundResult(
            participants=participants, stale=stale,
            forced=[r.client for r in forced], time=st.time,
            lost=lost, corrupted=corrupted, departed=departed,
            rejoined=rejoined,
            crashes=crashes, degraded=degraded, deadline_hit=deadline_hit,
            quorum=len(participants), target_k=self.k)

    # -- checkpoint / restore ----------------------------------------------
    def state_dict(self):
        """The scheduler's complete mutable state as plain data (lists,
        dicts, numbers, strings) — both heaps in their underlying list
        order (which already satisfies the heap invariant, so restore is a
        straight copy-in), every pending scratch list, and the exact
        bit-generator state of BOTH RNG streams (latency jitter and fault
        traffic). Restoring onto a scheduler built with the same
        constructor arguments reproduces the identical ``next_round()``
        sequence, draw for draw.

        The RNG entries are ``numpy`` ``bit_generator.state`` dicts and may
        contain >64-bit integers; callers serializing to formats without
        bignums (msgpack) must encode those themselves.
        """
        st = self.state
        return {
            "M": self.M,
            "time": float(st.time),
            "round": int(st.round),
            "runs": [[float(t), int(seq),
                      [int(r.client), int(r.base_version),
                       float(r.finish_time), str(r.fate)]]
                     for (t, seq, r) in st.runs],
            "events": [[float(t), int(seq), str(kind), int(c)]
                       for (t, seq, kind, c) in st.events],
            "versions": [[int(c), int(v)] for c, v in st.versions.items()],
            "online": [[int(c), bool(v)] for c, v in st.online.items()],
            "run_seq": [[int(c), int(s)] for c, s in st.run_seq.items()],
            "cancelled": sorted(int(s) for s in st.cancelled),
            "live_runs": int(st.live_runs),
            "pending_lost": [int(c) for c in st.pending_lost],
            "pending_corrupt": [int(c) for c in st.pending_corrupt],
            "pending_rejoin": sorted(int(c) for c in st.pending_rejoin),
            "pending_departed": [int(c) for c in st.pending_departed],
            "seq": int(st._seq),
            "rng": self._rng.bit_generator.state,
            "traffic_rng": self._traffic_rng.bit_generator.state,
        }

    def load_state_dict(self, d):
        """Restore :meth:`state_dict` output. The scheduler must have been
        constructed with the same fleet (``M`` is checked; the caller owns
        matching C/tau/jitter/traffic/seed — a mismatch there silently
        diverges, which is why the trainer fingerprints its full config)."""
        if int(d["M"]) != self.M:
            raise ValueError(f"scheduler state is for a fleet of "
                             f"{d['M']} clients, this scheduler has "
                             f"{self.M}")
        st = SchedulerState()
        st.time = float(d["time"])
        st.round = int(d["round"])
        st.runs = [(float(t), int(seq),
                    ClientRun(int(c), int(b), float(f), str(fate)))
                   for (t, seq, (c, b, f, fate)) in d["runs"]]
        st.events = [(float(t), int(seq), str(kind), int(c))
                     for (t, seq, kind, c) in d["events"]]
        st.versions = {int(c): int(v) for c, v in d["versions"]}
        st.online = {int(c): bool(v) for c, v in d["online"]}
        st.run_seq = {int(c): int(s) for c, s in d["run_seq"]}
        st.cancelled = set(int(s) for s in d["cancelled"])
        st.live_runs = int(d["live_runs"])
        st.pending_lost = [int(c) for c in d["pending_lost"]]
        st.pending_corrupt = [int(c) for c in d.get("pending_corrupt", [])]
        st.pending_rejoin = set(int(c) for c in d["pending_rejoin"])
        st.pending_departed = [int(c) for c in d["pending_departed"]]
        st._seq = int(d["seq"])
        self._rng.bit_generator.state = d["rng"]
        self._traffic_rng.bit_generator.state = d["traffic_rng"]
        self.state = st

"""The port's fault source (``core/traffic.py``) and its scheduler under
traffic, against the reference's: every draw from equal generators, the
reference churn profile field by field, and whole fault traces (crashes,
lost and corrupt uploads, churn, late joins, deadlines, quorum floors,
stalls) event for event. A trace is host numpy only, so it must match
exactly."""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import scheduler as j_scheduler  # noqa: E402
from repro.core import traffic as j_traffic  # noqa: E402
from repro_torch.core import fleet_ckpt  # noqa: E402
from repro_torch.core import scheduler, traffic  # noqa: E402

# the paper's measured 166..317 s client latency band
LATS = list(np.linspace(160.0, 320.0, 10))

PROFILES = {
    "churn": {},
    "churn-corrupt": {"corrupt_prob": 0.05},
    "heavy": {"crash_rate": 0.3, "upload_loss": 0.2, "corrupt_prob": 0.15,
              "tail_sigma": 1.0, "mean_online": 1500.0,
              "mean_offline": 900.0, "late_join_frac": 0.3},
    "no-churn": {"mean_online": math.inf, "late_join_frac": 0.0,
                 "crash_rate": 0.2},
}


def _profiles(name):
    fields = PROFILES[name]
    return (dataclasses.replace(traffic.REFERENCE_CHURN, **fields),
            dataclasses.replace(j_traffic.REFERENCE_CHURN, **fields))


def test_reference_churn_field_by_field():
    port = dataclasses.asdict(traffic.REFERENCE_CHURN)
    ref = dataclasses.asdict(j_traffic.REFERENCE_CHURN)
    assert port == ref and list(port) == list(ref)
    assert traffic.MAX_FAULT_RATE == j_traffic.MAX_FAULT_RATE
    assert traffic.TrafficModel() == traffic.TrafficModel(**dataclasses.asdict(
        j_traffic.TrafficModel()))


@pytest.mark.parametrize("bad", [
    {"crash_rate": -0.1}, {"crash_rate": 0.96}, {"upload_loss": 1.0},
    {"corrupt_prob": 0.99}, {"late_join_frac": 1.5}, {"tail_sigma": -1.0},
    {"mean_online": 0.0}, {"mean_offline": -5.0}, {"crash_rate": 0.95}])
def test_validation_matches_reference(bad):
    """The same profiles are refused, with the same message; a rate at the
    cap is accepted by both."""
    errors = []
    for cls in (traffic.TrafficModel, j_traffic.TrafficModel):
        try:
            cls(**bad)
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    assert errors[0] == errors[1]
    assert (errors[0] is None) == (bad == {"crash_rate": 0.95})


@pytest.mark.parametrize("name", list(PROFILES))
def test_every_draw_matches_reference(name):
    """Each draw from equal generators gives the same value and leaves the
    generators in the same state: three uniforms a fate, a fourth only
    when ``corrupt_prob > 0``."""
    port, ref = _profiles(name)
    gp, gr = np.random.default_rng(7), np.random.default_rng(7)
    assert port.initial_offline(gp, 40) == ref.initial_offline(gr, 40)
    for _ in range(200):
        assert port.latency_multiplier(gp) == ref.latency_multiplier(gr)
        assert port.run_fate(gp) == ref.run_fate(gr)
        assert port.online_duration(gp) == ref.online_duration(gr)
        assert port.offline_duration(gp) == ref.offline_duration(gr)
    assert gp.bit_generator.state == gr.bit_generator.state
    # the draw count a fate: 3, or 4 with the corruption axis on
    g = np.random.default_rng(0)
    before = g.bit_generator.state["state"]["state"]
    port.run_fate(g)
    ref_g = np.random.default_rng(0)
    for _ in range(4 if port.corrupt_prob > 0 else 3):
        ref_g.random()
    assert g.bit_generator.state == ref_g.bit_generator.state
    assert before != g.bit_generator.state["state"]["state"]


def _events(ev):
    return (tuple((r.client, r.base_version, r.finish_time, r.fate)
                  for r in ev.participants),
            ev.stale, ev.forced, ev.time, ev.lost, ev.corrupted, ev.departed,
            ev.rejoined, ev.crashes, ev.degraded, ev.deadline_hit, ev.quorum,
            ev.target_k)


def _pair(name, **kw):
    port, ref = _profiles(name)
    return (scheduler.SemiAsyncScheduler(LATS, traffic=port, **kw),
            j_scheduler.SemiAsyncScheduler(LATS, traffic=ref, **kw))


@pytest.mark.parametrize("name, kw", [
    ("churn", dict(C=0.6, tau=2, jitter=0.05, seed=0, deadline=700.0,
                   quorum_floor=2)),
    ("churn-corrupt", dict(C=0.6, tau=2, jitter=0.05, seed=3,
                           deadline=700.0, quorum_floor=2)),
    ("churn-corrupt", dict(C=0.5, tau=1, jitter=0.0, seed=11,
                           deadline=400.0, quorum_floor=1)),
    ("no-churn", dict(C=0.6, tau=0, jitter=0.05, seed=5)),
    ("heavy", dict(C=0.6, tau=2, jitter=0.05, seed=2, deadline=900.0,
                   quorum_floor=1))])
def test_scheduler_trace_matches_reference(name, kw):
    """Whole fault traces event for event, late joins included, up to the
    same ``FleetStalledError`` (same round, same diagnosis) where the
    profile starves the fleet."""
    port, ref = _pair(name, **kw)
    assert port.initial_offline == ref.initial_offline
    fired = set()
    for _ in range(40):
        outcome = []
        for s in (port, ref):
            try:
                outcome.append(_events(s.next_round()))
            except (scheduler.FleetStalledError,
                    j_scheduler.FleetStalledError) as exc:
                outcome.append(("stalled", str(exc)))
        assert outcome[0] == outcome[1]
        if outcome[0][0] == "stalled":
            break
        ev = outcome[0]
        fired |= {k for k, v in zip(
            ("lost", "corrupted", "departed", "rejoined", "crashes",
             "degraded", "deadline_hit"), ev[4:11]) if v}
    assert port.state_dict() == ref.state_dict()
    if name != "no-churn":
        assert {"departed", "rejoined", "crashes"} <= fired, fired


def test_fleet_stalled_error_matches_reference():
    """A fleet that starts entirely offline and never returns in time
    stalls on the first boundary, in both packages."""
    fields = dict(late_join_frac=1.0, mean_offline=1e9)
    p = scheduler.SemiAsyncScheduler(
        LATS, seed=0, quorum_floor=2,
        traffic=traffic.TrafficModel(**fields))
    r = j_scheduler.SemiAsyncScheduler(
        LATS, seed=0, quorum_floor=2,
        traffic=j_traffic.TrafficModel(**fields))
    with pytest.raises(scheduler.FleetStalledError) as ep:
        p.next_round()
    with pytest.raises(j_scheduler.FleetStalledError) as er:
        r.next_round()
    assert str(ep.value) == str(er.value)


@pytest.mark.parametrize("name", ["churn-corrupt", "heavy"])
def test_state_dict_round_trips_mid_trace(name):
    """A scheduler restored mid-trace (through the checkpoint encoding)
    replays the rest of the trace draw for draw."""
    kw = dict(C=0.6, tau=2, jitter=0.05, seed=4, deadline=800.0,
              quorum_floor=1)
    port, _ = _pair(name, **kw)
    for _ in range(5):
        port.next_round()
    saved = fleet_ckpt.unpack(fleet_ckpt.pack(port.state_dict()))
    twin, _ = _pair(name, **kw)
    twin.load_state_dict(saved)
    assert twin.state_dict() == port.state_dict()
    for _ in range(8):
        a, b = [], []
        for s, out in ((port, a), (twin, b)):
            try:
                out.append(_events(s.next_round()))
            except scheduler.FleetStalledError as exc:
                out.append(str(exc))
        assert a == b
    with pytest.raises(ValueError, match="fleet of"):
        scheduler.SemiAsyncScheduler(LATS[:4]).load_state_dict(saved)

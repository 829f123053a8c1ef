"""Host-side parity of the PyTorch port against the JAX package: the data
generator, the scheduler, the weighting functions, k-means and metrics
are numpy copies and must agree exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import functions as jfun  # noqa: E402
from repro.core import grouping as jgroup  # noqa: E402
from repro.core import metrics as jmet  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.data import synthetic_cicids as jdata  # noqa: E402
from repro_torch.core import functions as tfun  # noqa: E402
from repro_torch.core import grouping as tgroup  # noqa: E402
from repro_torch.core import metrics as tmet  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.data import synthetic_cicids as tdata  # noqa: E402


@pytest.mark.parametrize("scenario,scale,seed", [
    ("basic", 0.0015, 0), ("basic", 0.004, 3), ("balanced", 0.0015, 1)])
def test_make_dataset_arrays_equal(scenario, scale, seed):
    a = jdata.make_dataset(scenario, scale=scale, seed=seed)
    b = tdata.make_dataset(scenario, scale=scale, seed=seed)
    assert len(a["clients"]) == len(b["clients"])
    for ca, cb in zip(a["clients"], b["clients"]):
        np.testing.assert_array_equal(ca["x"], cb["x"])
        np.testing.assert_array_equal(ca["y"], cb["y"])
    for split in ("server", "test"):
        for key in ("x", "y"):
            np.testing.assert_array_equal(a[split][key], b[split][key])
    np.testing.assert_array_equal(a["counts"], b["counts"])
    np.testing.assert_array_equal(a["entropy"], b["entropy"])


def test_table_iii_and_entropy_equal():
    np.testing.assert_array_equal(jdata.BASIC_SCENARIO, tdata.BASIC_SCENARIO)
    np.testing.assert_array_equal(jdata.BALANCED_SCENARIO,
                                  tdata.BALANCED_SCENARIO)
    for row in np.concatenate([jdata.BASIC_SCENARIO,
                               jdata.BALANCED_SCENARIO]):
        assert jdata.shannon_entropy(row) == tdata.shannon_entropy(row)


def _schedule(mod, latencies, **kw):
    s = mod.SemiAsyncScheduler(latencies, **kw)
    out = []
    for _ in range(20):
        ev = s.next_round()
        out.append(([(r.client, r.base_version, r.finish_time)
                     for r in ev.participants], ev.stale, ev.forced, ev.time,
                    ev.quorum, ev.target_k))
    return out


@pytest.mark.parametrize("C,tau,jitter,seed", [
    (0.6, 2, 0.05, 0), (0.3, 1, 0.2, 7), (0.9, 3, 0.0, 2)])
def test_next_round_sequences_equal(C, tau, jitter, seed):
    sizes = np.random.default_rng(seed).integers(10, 5000, size=12)
    lat = [jsched.paper_latency(int(s)) for s in sizes]
    assert lat == [tsched.paper_latency(int(s)) for s in sizes]
    kw = dict(C=C, tau=tau, jitter=jitter, seed=seed)
    assert _schedule(jsched, lat, **kw) == _schedule(tsched, lat, **kw)


@pytest.mark.parametrize("M,k,seed", [(6, 3, 0), (10, 3, 1), (5, 5, 4)])
def test_kmeans_assignments_equal(M, k, seed):
    rng = np.random.default_rng(seed)
    hists = rng.dirichlet(np.ones(9) * 0.3, size=M).astype(np.float32)
    a, ca = jgroup.kmeans(hists, k, seed=seed)
    b, cb = tgroup.kmeans(hists, k, seed=seed)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(jgroup.group_clients(hists, k, seed=seed),
                                  tgroup.group_clients(hists, k, seed=seed))


def test_weighting_functions_equal():
    for name in ("constant", "polynomial", "hinge", "exponential"):
        g_j, g_t = jfun.staleness_fn(name), tfun.staleness_fn(name)
        assert [g_j(s) for s in range(6)] == [g_t(s) for s in range(6)]
    for mode in ("adaptive", "fixed_alpha", "fixed_beta"):
        assert [jfun.supervised_weight(r, C=0.6, M=10, mode=mode)
                for r in range(5)] == \
            [tfun.supervised_weight(r, C=0.6, M=10, mode=mode)
             for r in range(5)]
    part = (np.random.default_rng(0).random((5, 10)) < 0.6).astype(float)
    np.testing.assert_array_equal(
        jfun.adaptive_learning_rates(part, base_lr=1e-4,
                                     round_weight="exponential"),
        tfun.adaptive_learning_rates(part, base_lr=1e-4,
                                     round_weight="exponential"))


def test_weighted_metrics_equal():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 9, 500)
    p = np.where(rng.random(500) < 0.8, y, rng.integers(0, 9, 500))
    assert jmet.weighted_metrics(y, p, 9) == tmet.weighted_metrics(y, p, 9)

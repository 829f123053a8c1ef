"""The paper's comparison baselines (§V-F1) in the port against the JAX
package's own, on the CPU, from the reference's initial weights, with the
module's ``CNN_CONFIG`` patched in both packages to a reduced CNN with
dropout 0. Selections, event order, ART and forced syncs must match
exactly; global parameters at atol 1e-6 / rtol 1e-5, metrics within 1e-6,
ACO exactly (every baseline books dense bytes). The parameter bound sits
about 20x above the widest gap these runs give (4.5e-8) and far below
one Adam step (lr = 1e-4), so a dropped step fails it, as the planted
faults below show."""
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.baselines as jbase  # noqa: E402
import repro_torch.core.baselines as tbase  # noqa: E402
from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402

SMALL = dict(name="t", conv_filters=(8, 8), hidden=16, dropout=0.0)
SCALE, ROUNDS, SEED = 0.0015, 2, 0


@pytest.fixture
def small_cnn(monkeypatch):
    """Both packages' baselines on the reduced CNN; returns the
    reference's initial weights (the second half of
    ``split(PRNGKey(seed))``, as its ``_Base`` draws them)."""
    monkeypatch.setattr(jbase, "CNN_CONFIG", JCNN(**SMALL))
    monkeypatch.setattr(tbase, "CNN_CONFIG", CNNConfig(**SMALL))
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    return {n: np.asarray(v)
            for n, v in j_init_cnn(JCNN(**SMALL), k).items()}


class _Recorder:
    """Wraps the reference's selection generator and keeps each draw."""

    def __init__(self, rng):
        self.rng, self.draws = rng, []

    def choice(self, *args, **kw):
        sel = self.rng.choice(*args, **kw)
        self.draws.append([int(i) for i in sel])
        return sel


def _pair(name, init, rounds=ROUNDS, latencies=None, plant=None, **kw):
    """(reference trainer, its result, port trainer, its result); the
    reference's trained clients are recorded in ``ref.trained``;
    ``plant(port)``, when given, alters the port's trainer before it
    trains."""
    ref = getattr(jbase, name)(j_make_dataset("basic", scale=SCALE,
                                              seed=SEED),
                               JConfig(rounds=rounds, seed=SEED), **kw)
    ref.np_rng = _Recorder(ref.np_rng)
    ref.trained = []
    inner = ref._train_client

    def spy(i, params, lr):
        ref.trained.append(int(i))
        return inner(i, params, lr)

    ref._train_client = spy
    port = getattr(tbase, name)(make_dataset("basic", scale=SCALE,
                                             seed=SEED),
                                FedS3AConfig(rounds=rounds, seed=SEED,
                                             device="cpu"),
                                init_params=init, **kw)
    if latencies is not None:
        ref.latencies = list(latencies(ref.M))
        port.latencies = list(latencies(port.M))
    if plant is not None:
        plant(port)
    return ref, ref.train(), port, port.train()


def _same_floats(ref, want, port, got):
    jp = {n: np.asarray(v) for n, v in ref.global_params.items()}
    tp = params_to_numpy(port.global_params)
    assert set(tp) == set(jp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], atol=1e-6, rtol=1e-5,
                                   err_msg=n)
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) < 1e-6, m


@pytest.mark.parametrize("mode", ["partial", "all"])
def test_fedavg_ssl_matches_reference(small_cnn, mode):
    ref, want, port, got = _pair("FedAvgSSL", small_cnn, mode=mode)
    if mode == "partial":
        assert port.selections == ref.np_rng.draws
        assert all(len(s) == 6 for s in port.selections)
    else:
        assert ref.np_rng.draws == []
        assert port.selections == [list(range(port.M))] * ROUNDS
    assert ref.trained == [i for s in port.selections for i in s]
    assert got["art"] == want["art"]
    assert got["aco"] == want["aco"] == 1.0
    assert got["rounds"] == want["rounds"] == ROUNDS
    assert (port.comm_bytes, port.dense_bytes) == (ref.comm_bytes,
                                                   ref.dense_bytes)
    _same_floats(ref, want, port, got)


def test_fedasync_ssl_matches_reference(small_cnn):
    ref, want, port, got = _pair("FedAsyncSSL", small_cnn, rounds=4)
    assert port.arrivals == ref.trained
    assert got["art"] == want["art"]
    assert got["forced_syncs"] == want["forced_syncs"]
    assert got["aco"] == want["aco"] == 1.0
    _same_floats(ref, want, port, got)


@pytest.mark.parametrize("max_stale, slow", [(2, 5.0), (0, 2.5)])
def test_fedasync_straggler_forced_syncs_match_reference(small_cnn,
                                                         max_stale, slow):
    """The two-speed fleet of tests/test_baselines.py: client 0 laps the
    others, so stragglers arrive past ``max_stale`` and are force-synced
    (one downlink each, no round consumed)."""
    rounds = 12 if max_stale else 4
    ref, want, port, got = _pair(
        "FedAsyncSSL", small_cnn, rounds=rounds, max_stale=max_stale,
        latencies=lambda m: [1.0] + [slow] * (m - 1))
    assert got["forced_syncs"] == want["forced_syncs"] > 0
    assert port.arrivals == ref.trained
    assert got["art"] == want["art"]
    assert got["rounds"] == rounds
    n = sum(v.numel() for v in port.global_params.values())
    assert port.comm_bytes == ref.comm_bytes == \
        (2 * rounds + port.forced_syncs) * n * 4
    assert got["aco"] == want["aco"]
    _same_floats(ref, want, port, got)


def test_local_ssl_matches_reference(small_cnn):
    ref, want, port, got = _pair("LocalSSL", small_cnn)
    assert math.isnan(got["art"]) and math.isnan(got["aco"])
    assert math.isnan(want["art"]) and math.isnan(want["aco"])
    assert got["rounds"] == want["rounds"]
    _same_floats(ref, want, port, got)


def _skip_server_step(port, monkeypatch):
    monkeypatch.setattr(port, "_server_step", lambda: port.global_params)


def _swap_fedavg_weights(port, monkeypatch):
    inner = tbase.agg.fedavg_ssl
    monkeypatch.setattr(tbase.agg, "fedavg_ssl",
                        lambda sp, models, sizes, fw: inner(
                            sp, models, sizes[::-1], fw))


def _skip_one_client_epoch(port, monkeypatch):
    inner, calls = port.client_epoch, [0]

    def epoch(params, opt, x, lr, masks):
        calls[0] += 1
        if calls[0] == 2:
            return params, opt, None
        return inner(params, opt, x, lr, masks)

    monkeypatch.setattr(port, "client_epoch", epoch)


@pytest.mark.parametrize("plant", [_skip_server_step, _swap_fedavg_weights,
                                   _skip_one_client_epoch])
def test_planted_fault_fails_the_parity_bound(small_cnn, monkeypatch, plant):
    """Control of the parameter bound: a port that skips one server step,
    swaps FedAvg's size weights or skips one client epoch leaves it."""
    ref, want, port, got = _pair("FedAvgSSL", small_cnn, mode="partial",
                                 plant=lambda p: plant(p, monkeypatch))
    assert port.selections == ref.np_rng.draws
    with pytest.raises(AssertionError):
        _same_floats(ref, want, port, got)


def test_empty_ledger_aco_is_zero(small_cnn):
    port = tbase.FedAvgSSL(make_dataset("basic", scale=SCALE, seed=SEED),
                           FedS3AConfig(rounds=1, device="cpu",
                                        init_server_epochs=0))
    assert port.aco == 0.0


def test_each_epoch_gets_its_own_masks(monkeypatch):
    """epochs > 1: every epoch of a client draws its own dropout masks
    (the reference derives ``fold_in(k, e)`` per epoch)."""
    monkeypatch.setattr(tbase, "CNN_CONFIG",
                        CNNConfig(name="t", conv_filters=(4, 4), hidden=8))
    tr = tbase.FedAvgSSL(make_dataset("basic", scale=SCALE, seed=SEED),
                         FedS3AConfig(rounds=1, epochs=3, device="cpu",
                                      init_server_epochs=0))
    seen, inner = [], tr.client_epoch

    def spy(params, opt, x, lr, masks):
        seen.append(masks.clone())
        return inner(params, opt, x, lr, masks)

    tr.client_epoch = spy
    tr._train_client(0, tr.global_params, tr.cfg.lr)
    assert len(seen) == 3
    assert not torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[1], seen[2])


def test_the_model_is_the_module_cnn_whatever_config_says(small_cnn):
    tr = tbase.LocalSSL(make_dataset("basic", scale=SCALE, seed=SEED),
                        FedS3AConfig(cnn=CNNConfig(conv_filters=(2, 2),
                                                   hidden=4),
                                     device="cpu", init_server_epochs=0),
                        init_params=small_cnn)
    assert tr.cnn == CNNConfig(**SMALL)
    assert tr.global_params["out_w"].shape == (16, 9)


def _trees(rng, k):
    shapes = {"a": (3, 4), "b": (5,)}
    return [{n: rng.normal(size=s).astype(np.float32)
             for n, s in shapes.items()} for _ in range(k)]


def test_fedavg_aggregations_match_reference():
    rng = np.random.default_rng(0)
    server, *clients = _trees(rng, 4)
    sizes = [30, 7, 12]
    j = jagg.fedavg_ssl(server, clients, sizes, 0.3)
    t = tagg.fedavg_ssl({n: torch.from_numpy(v) for n, v in server.items()},
                        [{n: torch.from_numpy(v) for n, v in c.items()}
                         for c in clients], sizes, 0.3)
    for n in j:
        np.testing.assert_allclose(t[n].numpy(), np.asarray(j[n]),
                                   atol=1e-6, rtol=1e-6)
    for s in (0, 3, 40):
        j = jagg.fedasync_blend(server, clients[0], staleness=s)
        t = tagg.fedasync_blend(
            {n: torch.from_numpy(v) for n, v in server.items()},
            {n: torch.from_numpy(v) for n, v in clients[0].items()},
            staleness=s)
        for n in j:
            np.testing.assert_array_equal(t[n].numpy(), np.asarray(j[n]))

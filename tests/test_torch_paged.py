"""The participant-paged client store (``client_store="paged"``) in the
port's trainer, on the CPU. A paged run is a memory layout, not an
algorithm: on either engine and every wire it must give its resident
twin's schedules, parameters, metrics and ACO bit for bit (the reference's
own invariant, tests/test_engine_parity.py:140-155). The port's paged
sequential run is held against the reference's paged sequential run
within the cross-engine bounds (metrics < 1e-4, ACO < 2e-3); the fleet
dataset against the reference's, array for array; and the device's
client-state bytes must not grow with the fleet."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402
from repro.data import make_fleet_dataset as j_make_fleet  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core.client_store import (PagedClientStore,  # noqa: E402
                                           ResidentStore)
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_dataset, make_fleet_dataset  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402

SMALL = dict(name="t", conv_filters=(8, 8), hidden=16, dropout=0.0)
SCALE, SEED = 0.0015, 0
# tau = 0 forces stragglers every round, so the paged runs retire pages
WIRES = {"csr-ef": {"wire_format": "csr", "error_feedback": True},
         "csrq-ef": {"wire_format": "csr_q", "error_feedback": True},
         "dense-ef": {"wire_format": "dense_masked", "error_feedback": True},
         "csr": {"wire_format": "csr"}}


def _run(store, engine, rounds=3, data=None, **kw):
    cfg = dict(rounds=rounds, cnn=CNNConfig(**SMALL), seed=SEED,
               device="cpu", engine=engine, tau=0, client_store=store)
    cfg.update(kw)
    tr = FedS3ATrainer(data or make_dataset("basic", scale=SCALE, seed=SEED),
                       FedS3AConfig(**cfg))
    return tr, tr.train()


def _bit_equal(a, out_a, b, out_b):
    for la, lb in zip(a.logs, b.logs, strict=True):
        assert (la.participants, la.stalenesses, la.forced, la.time) == \
            (lb.participants, lb.stalenesses, lb.forced, lb.time)
    pa, pb = params_to_numpy(a.global_params), params_to_numpy(b.global_params)
    for k in pa:
        assert np.array_equal(pa[k], pb[k]), k
    assert out_a["metrics"] == out_b["metrics"]
    assert out_a["aco"] == out_b["aco"]
    np.testing.assert_array_equal(a.base_versions, b.base_versions)


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("wire", list(WIRES))
def test_paged_equals_resident_bit_for_bit(engine, wire):
    res, out_r = _run("resident", engine, **WIRES[wire])
    pag, out_p = _run("paged", engine, **WIRES[wire])
    assert pag.engine == res.engine == engine
    assert any(log.forced for log in pag.logs)
    _bit_equal(res, out_r, pag, out_p)
    assert isinstance(pag.cstore, PagedClientStore)
    ef = WIRES[wire].get("error_feedback", False)
    assert pag.cstore.layout == ({"dense_masked": "dense"}.get(
        WIRES[wire]["wire_format"], "csr") if ef else "none")
    # every client's residual: the resident row is the page's decode
    if ef:
        assert isinstance(res.cstore, ResidentStore)
        for i in range(res.M):
            np.testing.assert_array_equal(pag.cstore.residual_row(i),
                                          res.cstore.residual_row(i))
    # the store's counters are the participation matrix's
    np.testing.assert_array_equal(pag.cstore.part_count,
                                  res.participation.sum(axis=0))
    # less client state on the device, except a sequential run without EF,
    # where neither store holds any
    if ef or engine == "batched":
        assert pag.client_state_device_bytes() < \
            res.client_state_device_bytes()


@pytest.mark.parametrize("wire", ["csr", "dense_masked"])
def test_paged_sequential_matches_reference_paged(wire):
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    init = {n: np.asarray(v) for n, v in j_init_cnn(JCNN(**SMALL),
                                                    k).items()}
    kw = dict(rounds=3, tau=0, seed=SEED, engine="sequential",
              client_store="paged", error_feedback=True, wire_format=wire)
    ref = JTrainer(j_make_dataset("basic", scale=SCALE, seed=SEED),
                   JConfig(cnn=JCNN(**SMALL), use_kernels=False, **kw))
    want = ref.train()
    port = FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                         FedS3AConfig(cnn=CNNConfig(**SMALL), device="cpu",
                                      **kw),
                         init_params=init)
    got = port.train()
    for a, b in zip(port.logs, ref.logs, strict=True):
        assert (a.participants, a.stalenesses, a.forced, a.time, a.art) == \
            (b.participants, b.stalenesses, b.forced, b.time, b.art)
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) < 1e-4, m
    assert abs(got["aco"] - want["aco"]) < 2e-3
    np.testing.assert_array_equal(port.cstore.part_count,
                                  ref.cstore.part_count)
    np.testing.assert_array_equal(port.cstore.last_round,
                                  ref.cstore.last_round)
    np.testing.assert_array_equal(port.cstore.valid, ref.cstore.valid)
    assert port.client_state_device_bytes() == \
        ref.client_state_device_bytes()
    assert port.residual_store_bytes() == ref.residual_store_bytes()


def test_fleet_dataset_matches_reference():
    for kw in (dict(num_clients=200, pool=8), dict(num_clients=30)):
        want, got = j_make_fleet(**kw), make_fleet_dataset(**kw)
        assert want.keys() == got.keys()
        assert len(got["clients"]) == kw["num_clients"]
        for a, b in zip(want["clients"], got["clients"], strict=True):
            np.testing.assert_array_equal(a["x"], b["x"])
            np.testing.assert_array_equal(a["y"], b["y"])
        for split in ("server", "test"):
            for k in ("x", "y"):
                np.testing.assert_array_equal(want[split][k], got[split][k])
        for k in want.keys() - {"clients", "server", "test"}:
            np.testing.assert_array_equal(want[k], got[k])
    pooled = make_fleet_dataset(200, pool=8)
    assert pooled["pool"] == 8
    assert pooled["clients"][9] is pooled["clients"][1]


def test_device_client_state_is_flat_in_m():
    """The same K = 4 participants a round at M = 50 and M = 500 (pooled
    data, batched, csr + EF): the paged device bytes are equal, below the
    resident layout's, which grow with M."""
    got = {}
    for m in (50, 500):
        tr, out = _run("paged", "batched", rounds=2, C=4 / m,
                       data=make_fleet_dataset(m, pool=8, seed=SEED),
                       wire_format="csr", error_feedback=True)
        assert all(len(log.participants) == 4 for log in tr.logs)
        assert not hasattr(tr, "_x_pad")
        assert tr._x_pad_h.shape[0] == 8
        got[m] = (tr.client_state_device_bytes(),
                  tr.client_state_resident_equiv_bytes(),
                  tr.client_state_host_bytes())
    assert got[50][0] == got[500][0] > 0
    assert got[500][1] > 9 * got[50][1]
    assert got[50][0] < got[50][1]
    assert got[500][2] > got[50][2]


def test_paged_dir_memory_maps_the_pages(tmp_path):
    mem, out_m = _run("paged", "batched", wire_format="csr",
                      error_feedback=True)
    mapped, out_d = _run("paged", "batched", wire_format="csr",
                         error_feedback=True, paged_dir=tmp_path / "pages")
    assert isinstance(mapped.cstore.res_vals, np.memmap)
    assert (tmp_path / "pages" / "res_vals.npy").is_file()
    _bit_equal(mem, out_m, mapped, out_d)

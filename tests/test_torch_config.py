"""The port's ``FedS3AConfig`` takes every field of the reference's that
the ported slice can honour, and ``repro_torch.core`` exports the ported
classes under the reference's names. Configs are held against the
reference's own ``FedS3ATrainer`` on a reduced CNN at a tiny data scale."""
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import feds3a  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(name="t", conv_filters=(4, 4), hidden=8, dropout=0.0)
SCALE = 0.0015


def _port(**kw):
    return FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=0),
                         FedS3AConfig(rounds=1, cnn=CNNConfig(**SMALL),
                                      device="cpu", **kw))


def _deprecations(build):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        obj = build()
    return obj, [str(w.message) for w in caught
                 if issubclass(w.category, DeprecationWarning)
                 and "batched=" in str(w.message)]


@pytest.mark.parametrize("engine", [None, "sequential", "batched"])
@pytest.mark.parametrize("batched", [True, False])
def test_legacy_batched_resolves_as_the_reference(batched, engine):
    """``batched=`` maps onto an unset ``engine`` (an explicit engine
    wins), with the reference's ``DeprecationWarning``; the port's trainer
    then runs a round on the engine the reference picked."""
    ref, ref_warned = _deprecations(lambda: JTrainer(
        j_make_dataset("basic", scale=SCALE, seed=0),
        JConfig(rounds=1, cnn=JCNN(**SMALL), batched=batched,
                engine=engine)))
    port, port_warned = _deprecations(
        lambda: _port(batched=batched, engine=engine))
    assert port.engine == ref.engine
    assert port_warned == ref_warned and len(port_warned) == 1
    assert port.train()["rounds"] == 1


def test_no_warning_without_batched():
    port, warned = _deprecations(lambda: _port())
    assert warned == [] and port.engine == "batched"


def test_use_kernels_and_server_epochs_change_nothing():
    """Both are accepted; neither changes a round: the device alone
    decides between the kernels and their plain versions, and the
    reference reads ``server_epochs`` nowhere either."""
    want = _port(engine="sequential").train()
    got = _port(engine="sequential", use_kernels=True,
                server_epochs=2).train()
    assert got["metrics"] == want["metrics"]
    assert got["aco"] == want["aco"] and got["art"] == want["art"]


def test_every_reference_field_is_a_port_field():
    """Each field of the reference's config exists in the port's, so a
    reference config never raises ``TypeError`` there."""
    import dataclasses
    ref = {f.name for f in dataclasses.fields(JConfig)}
    port = {f.name for f in dataclasses.fields(FedS3AConfig)}
    assert ref - port == set()


def test_paged_dir_raises_naming_queue_4(tmp_path):
    """``paged_dir`` is ported with the paged client store: the residual
    pages are memory-mapped under it. The fleet checkpoint a paged
    deployment pairs with it is ported too (it raised, naming queue 4,
    before): a checkpoint of a memory-mapped paged run restores onto a
    fresh trainer with its own ``paged_dir``, and the two go on equal."""
    kw = dict(client_store="paged", error_feedback=True,
              checkpoint_dir=str(tmp_path / "ckpt"))
    tr = _port(paged_dir=str(tmp_path / "a"), **kw)
    assert tr.train()["rounds"] == 1
    assert (tmp_path / "a" / "res_vals.npy").is_file()
    tr.save_checkpoint()
    twin = _port(paged_dir=str(tmp_path / "b"), **kw)
    assert twin.restore() == 1
    for i in range(tr.M):
        np.testing.assert_array_equal(twin.cstore.residual_row(i),
                                      tr.cstore.residual_row(i))
    assert isinstance(twin.cstore.res_vals, np.memmap)
    a, b = tr.train(1), twin.train(1)
    assert a["metrics"] == b["metrics"] and a["aco"] == b["aco"]
    assert np.array_equal(tr._global_flat.numpy(), twin._global_flat.numpy())


def test_select_engine_maps_batched():
    cpu = torch.device("cpu")
    with pytest.warns(DeprecationWarning, match="batched="):
        assert feds3a.select_engine(None, cpu, 10, batched=False) == \
            "sequential"
    assert feds3a.select_engine(None, cpu, 10) == "batched"
    assert feds3a.select_engine(None, cpu, 10**6) == "sequential"


def test_core_exports_the_ported_classes_without_jax():
    code = textwrap.dedent("""
        import sys
        from repro_torch.core import (FedAsyncSSL, FedAvgSSL, FedS3AConfig,
                                      FedS3ATrainer, FleetStalledError,
                                      LocalSSL, PagedClientStore,
                                      REFERENCE_CHURN, TrafficModel,
                                      VersionedBaseStore, WireIntegrityError)
        from repro_torch.core import (base_store, baselines, client_store,
                                      feds3a, fleet_ckpt, scheduler,
                                      sparse_comm, traffic)
        assert (TrafficModel, REFERENCE_CHURN) == (traffic.TrafficModel,
                                                   traffic.REFERENCE_CHURN)
        assert FleetStalledError is scheduler.FleetStalledError
        assert WireIntegrityError is sparse_comm.WireIntegrityError
        assert fleet_ckpt.FORMAT_VERSION == 1
        assert FedS3AConfig is feds3a.FedS3AConfig
        assert FedS3ATrainer is feds3a.FedS3ATrainer
        assert VersionedBaseStore is base_store.VersionedBaseStore
        assert PagedClientStore is client_store.PagedClientStore
        assert (FedAvgSSL, FedAsyncSSL, LocalSSL) == (
            baselines.FedAvgSSL, baselines.FedAsyncSSL, baselines.LocalSSL)
        bad = [m for m in sys.modules
               if m == "jax" or m == "repro" or m.startswith(("jax.",
                                                              "repro."))]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

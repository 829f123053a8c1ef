"""The whole slice: the port's ``FedS3ATrainer`` on the CPU against the JAX
package's sequential engine, from the reference's own initial weights, on
a reduced CNN with dropout 0. Schedules must match exactly; global
parameters at atol 1e-4 / rtol 1e-3; metrics within 1e-4 and ACO within
2e-3, the reference's own cross-engine bounds
(tests/test_engine_parity.py:125, :136)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(name="t", conv_filters=(8, 8), hidden=16, dropout=0.0)


def test_trainer_matches_reference_sequential_engine():
    scale, rounds, seed = 0.0015, 2, 0
    # the reference's _init_models draws its weights from the second half
    # of split(PRNGKey(seed))
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    init = {n: np.asarray(v) for n, v in j_init_cnn(JCNN(**SMALL), k).items()}
    ref = JTrainer(j_make_dataset("basic", scale=scale, seed=seed),
                   JConfig(rounds=rounds, cnn=JCNN(**SMALL), seed=seed,
                           engine="sequential", use_kernels=False))
    want = ref.train()
    port = FedS3ATrainer(make_dataset("basic", scale=scale, seed=seed),
                         FedS3AConfig(rounds=rounds, cnn=CNNConfig(**SMALL),
                                      seed=seed, device="cpu",
                                      engine="sequential"),
                         init_params=init)
    got = port.train()

    assert len(port.logs) == len(ref.logs) == rounds
    for a, b in zip(port.logs, ref.logs):
        assert (a.round, a.participants, a.stalenesses, a.forced, a.time,
                a.art) == (b.round, b.participants, b.stalenesses, b.forced,
                           b.time, b.art)
    np.testing.assert_array_equal(port.base_versions, ref.base_versions)
    jp = {n: np.asarray(v) for n, v in ref.global_params.items()}
    tp = params_to_numpy(port.global_params)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], atol=1e-4, rtol=1e-3,
                                   err_msg=n)
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) < 1e-4, m
    assert abs(got["aco"] - want["aco"]) < 2e-3
    assert got["fleet"] == want["fleet"] and got["rounds"] == want["rounds"]
    assert got["art"] == want["art"]
    # the same ring, chain, versions and detach flags
    assert port.store.bytes() == ref.store.bytes()


def test_port_runs_without_jax_or_the_reference_package():
    code = textwrap.dedent("""
        import sys
        from repro_torch.configs.feds3a_cnn import CNNConfig
        from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer
        from repro_torch.data import make_dataset
        from repro_torch.kernels import build, ops, ref  # noqa: F401
        from repro_torch.core import baselines, client_store
        cnn = CNNConfig(conv_filters=(4, 4), hidden=8)
        out = FedS3ATrainer(make_dataset("basic", scale=0.0015),
                            FedS3AConfig(rounds=1, cnn=cnn, device="cpu",
                                         client_store="paged",
                                         error_feedback=True)
                            ).train()
        assert out["rounds"] == 1
        baselines.CNN_CONFIG = cnn
        out = baselines.FedAvgSSL(make_dataset("basic", scale=0.0015),
                                  FedS3AConfig(rounds=1, device="cpu")
                                  ).train()
        assert out["rounds"] == 1 and out["aco"] == 1.0
        assert client_store.PagedClientStore(4, 8, 2, device="cpu").M == 4
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print("isolated")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    data = make_dataset("basic", scale=0.0015)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FedS3ATrainer(data, FedS3AConfig(cnn=CNNConfig(**SMALL)))


@pytest.mark.parametrize("override", [
    pytest.param({"engine": "sharded"}, id="override0"),
    pytest.param({"client_store": "paged", "error_feedback": True,
                  "engine": "sharded"}, id="override1"),
    pytest.param({"wire_format": "csr_q", "chunk_size": 64,
                  "engine": "sharded"}, id="override2"),
    pytest.param({"base_store": "dense", "engine": "sharded"},
                 id="override3"),
    pytest.param({"model": "qwen2-1.5b", "chunk_size": 64,
                  "client_store": "paged"}, id="override9")])
def test_outside_the_slice_raises(override):
    if "model" in override:
        # the FL language-model path is ported, chunked too; on the paged
        # client store it is not
        from repro_torch.configs import get_config, load_all
        load_all()
        override = dict(override,
                        model=get_config(override["model"]).reduced())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FedS3ATrainer(make_dataset("basic", scale=0.0015),
                      FedS3AConfig(cnn=CNNConfig(**SMALL), device="cpu",
                                   **override))


@pytest.mark.parametrize("override", [
    pytest.param({"client_store": "paged", "checkpoint_dir": "c"},
                 id="override4"),
    pytest.param({"chunk_size": 64, "layer_keep_frac": {"conv": 0.5},
                  "checkpoint_dir": "ckpt"}, id="override5"),
    pytest.param({"round_deadline": 700.0}, id="override6"),
    pytest.param({"chunk_size": 64, "round_deadline": 700.0},
                 id="override7"),
    pytest.param({"checkpoint_dir": "ckpt"}, id="override8")])
def test_faults_and_checkpoints_are_in_the_slice(override, tmp_path):
    """The fault layer's deadline and the fleet checkpoints are ported:
    each config that raised before builds and runs a round (checkpoints
    under ``tmp_path``)."""
    if "checkpoint_dir" in override:
        override = dict(override,
                        checkpoint_dir=str(tmp_path / override[
                            "checkpoint_dir"]))
    tr = FedS3ATrainer(make_dataset("basic", scale=0.0015),
                       FedS3AConfig(cnn=CNNConfig(**SMALL), device="cpu",
                                    rounds=1, **override))
    assert tr.train()["rounds"] == 1
    if "checkpoint_dir" in override:
        assert tr.save_checkpoint().startswith(str(tmp_path))


@pytest.mark.parametrize("override, match", [
    ({"layer_keep_frac": {"conv": 0.5}}, "layer_keep_frac requires"),
    ({"layer_keep_frac": {"conv": 0.5}, "engine": "sharded"},
     "layer_keep_frac requires"),
    ({"chunk_size": 64, "wire_format": "dense_masked"}, "CSR-family"),
    ({"chunk_size": 64, "sparse_comm": False}, "CSR-family"),
    ({"chunk_size": 64, "sparse_comm": False, "checkpoint_dir": "c"},
     "CSR-family"),
    ({"chunk_size": 64, "base_store": "dense"}, "base_store='versioned'")])
def test_chunking_config_errors(override, match):
    """The reference's chunking ``ValueError``s, each raised before any
    refusal of a value outside the slice."""
    with pytest.raises(ValueError, match=match):
        FedS3ATrainer(make_dataset("basic", scale=0.0015),
                      FedS3AConfig(cnn=CNNConfig(**SMALL), device="cpu",
                                   **override))


def test_flat_chunking_needs_no_csr_wire():
    """A chunk size of N or more is the flat path, on any wire."""
    tr = FedS3ATrainer(make_dataset("basic", scale=0.0015),
                       FedS3AConfig(cnn=CNNConfig(**SMALL), device="cpu",
                                    chunk_size=10**7,
                                    wire_format="dense_masked"))
    assert tr.layout is None and not tr.chunked

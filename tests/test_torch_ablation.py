"""The paper's ablation axes (Tables V-XI) in a trainer run: the port's
sequential engine on the CPU against the reference's sequential engine
(``use_kernels=False``), from the reference's own initial weights, on a
reduced CNN with dropout 0, 2 rounds, one case per axis value. Bounds,
the reference's own cross-engine ones (tests/test_engine_parity.py:125,
:136): schedules, stalenesses, forced sets and base versions exact;
parameters atol 1e-4 / rtol 1e-3; metrics 1e-4; ACO 2e-3."""
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

SMALL = dict(name="t", conv_filters=(8, 8), hidden=16, dropout=0.0)
SCALE, ROUNDS, SEED = 0.0015, 2, 0

# (config fields, make_dataset fields): Table V staleness functions, VI
# round weights and the adaptive learning rate, VII tau, VIII C, IX the
# server's labeled share, X grouping, XI the supervised weight, and the
# balanced scenario
AXES = {
    "staleness-constant": ({"staleness_function": "constant"}, {}),
    "staleness-polynomial": ({"staleness_function": "polynomial"}, {}),
    "staleness-hinge": ({"staleness_function": "hinge"}, {}),
    "round-constant": ({"round_weight_function": "constant"}, {}),
    "round-logarithmic": ({"round_weight_function": "logarithmic"}, {}),
    "round-polynomial": ({"round_weight_function": "polynomial"}, {}),
    "round-exp-smoothing": (
        {"round_weight_function": "exponential_smoothing"}, {}),
    "no-adaptive-lr": ({"adaptive_lr": False}, {}),
    "tau-3": ({"tau": 3}, {}),
    "tau-4": ({"tau": 4}, {}),
    "C-0.1": ({"C": 0.1}, {}),
    "C-1.0": ({"C": 1.0}, {}),
    "server-frac-0.01": ({}, {"server_frac": 0.01}),
    "server-frac-0.07": ({}, {"server_frac": 0.07}),
    "no-groups": ({"group_based": False}, {}),
    "fixed-alpha": ({"supervised_weight_mode": "fixed_alpha"}, {}),
    "fixed-beta": ({"supervised_weight_mode": "fixed_beta"}, {}),
    "balanced": ({}, {"scenario": "balanced"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def init():
    # the reference's _init_models draws from the second half of
    # split(PRNGKey(seed))
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    return {n: np.asarray(v) for n, v in j_init_cnn(JCNN(**SMALL), k).items()}


@pytest.mark.parametrize("axis", list(AXES))
def test_axis_matches_reference_sequential(axis, init):
    fields, data_kw = AXES[axis]
    data_kw = dict(data_kw)
    scenario = data_kw.pop("scenario", "basic")
    ref = JTrainer(j_make_dataset(scenario, scale=SCALE, seed=SEED,
                                  **data_kw),
                   JConfig(rounds=ROUNDS, cnn=JCNN(**SMALL), seed=SEED,
                           engine="sequential", use_kernels=False, **fields))
    want = ref.train()
    port = FedS3ATrainer(make_dataset(scenario, scale=SCALE, seed=SEED,
                                      **data_kw),
                         FedS3AConfig(rounds=ROUNDS, cnn=CNNConfig(**SMALL),
                                      seed=SEED, device="cpu",
                                      engine="sequential", **fields),
                         init_params=init)
    got = port.train()
    assert len(port.logs) == len(ref.logs) == ROUNDS
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
    assert got["fleet"] == want["fleet"]

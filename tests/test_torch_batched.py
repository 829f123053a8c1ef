"""The port's batched engine on the CPU against the JAX package, at a
reduced width with dropout 0 (the two packages draw different random
bits): its stacked forward, per-row Adam, batched client epoch, batched
histograms, flat server epoch and flat blends against the reference's
counterparts, and whole trainers against the reference's SEQUENTIAL
engine (``use_kernels=False``) on the csr and dense_masked wires and the
disabled channel. Trainers are held to the reference's own cross-engine
criteria (``tests/test_engine_parity.py:125, :136``): exact schedules,
parameters at atol 1e-4 / rtol 1e-3, metrics within 1e-4, ACO within
2e-3. Modules at atol 1e-5: float32 products summed in another order."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import pseudo_label as jpl  # noqa: E402
from repro.core import sparse_comm as jsc  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optimizer import adam as jadam  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import pseudo_label as tpl  # noqa: E402
from repro_torch.core import sparse_comm as tsc  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.optimizer import adam as tadam  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402,E501

SMALL = dict(conv_filters=(8, 8), hidden=16, dropout=0.0)
ATOL = 1e-5
B = 100
SIZES = (237, 60, 100)          # 3, 1 and 1 batches, padded to 3


def _init(seed=0):
    p = jcnn.init_cnn(JCNN(**SMALL), jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in p.items()}


def _stack(seeds):
    return np.stack([np.asarray(jsc.flatten_tree(_init(s))) for s in seeds])


def _clients(sizes=SIZES, seed=5):
    """Per-client data padded to a common batch count: (K, nb*B, 78)
    features and (K, nb*B) validity."""
    rng = np.random.default_rng(seed)
    nb = max(-(-n // B) for n in sizes)
    x = np.zeros((len(sizes), nb * B, 78), np.float32)
    v = np.zeros((len(sizes), nb * B), np.float32)
    for k, n in enumerate(sizes):
        x[k, :n] = rng.standard_normal((n, 78)).astype(np.float32) * 2
        v[k, :n] = 1.0
    return x, v


def test_stacked_forward_is_each_clients_forward():
    flat = _stack((0, 1, 2))
    x = np.random.default_rng(0).standard_normal((3, 37, 78)).astype(
        np.float32)
    cfg = CNNConfig(**SMALL)
    template = tcnn.cnn_template(cfg)
    got = tcnn.cnn_forward_stacked(
        cfg, tsc.unflatten_stacked(torch.from_numpy(flat), template),
        torch.from_numpy(x))
    for k in range(3):
        tree = jsc.unflatten_like(jnp.asarray(flat[k]), _init(k))
        want = jcnn.cnn_forward(JCNN(**SMALL), tree, jnp.asarray(x[k]))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
    assert {k: tuple(v.shape) for k, v in template.items()} == \
        {k: v.shape for k, v in _init().items()}


def test_adam_rows_match_and_dead_rows_stand_still():
    """Three steps on (3, N) rows with per-row rates, row 1 dead on the
    second step: live rows equal the reference's Adam on each row; a dead
    step leaves the row's parameters, moments and step count exactly."""
    flat = _stack((0, 1, 2))
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(flat.shape).astype(np.float32) * 1e-2
             for _ in range(3)]
    lrs = np.array([1e-3, 5e-4, 2e-3], np.float32)
    lives = [np.array([1, 1, 1], bool), np.array([1, 0, 1], bool),
             np.array([1, 1, 1], bool)]
    tf = torch.from_numpy(flat)
    to = tadam.adam_init_rows(tf)
    for g, live in zip(grads, lives):
        before = {k: v.clone() for k, v in to.items()}, tf.clone()
        tf, to = tadam.adam_update_rows(torch.from_numpy(g), to, tf,
                                        lr=torch.from_numpy(lrs),
                                        live=torch.from_numpy(live),
                                        l1=1e-5)
        if not live[1]:
            assert torch.equal(tf[1], before[1][1])
            for k in ("m", "v", "t"):
                assert torch.equal(to[k][1], before[0][k][1])
    assert to["t"].tolist() == [3, 2, 3]
    for k in range(3):
        jp, jo = jnp.asarray(flat[k]), jadam.adam_init(jnp.asarray(flat[k]))
        for g, live in zip(grads, lives):
            if live[k]:
                jp, jo = jadam.adam_update(jnp.asarray(g[k]), jo, jp,
                                           lr=jnp.float32(lrs[k]), l1=1e-5)
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jp), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(to["m"][k].numpy(), np.asarray(jo["m"]),
                                   atol=1e-6, rtol=0)


def test_batched_client_epoch_matches_reference():
    """Unequal clients (3, 1 and 1 batches, padded to 3); threshold 0.5 so
    that rows pass the mask; the reference runs its Pallas loss in
    interpret mode. The padded batches take no step."""
    flat = _stack((0, 1, 2))
    x, v = _clients()
    lrs = np.array([1e-3, 5e-4, 2e-3], np.float32)
    jrun = jpl.make_batched_client_epoch(JCNN(**SMALL), batch_size=B,
                                         threshold=0.5, l1=1e-5,
                                         use_kernel=True)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jf, jl = jrun(jnp.asarray(flat), jnp.asarray(x), jnp.asarray(v), lrs,
                  keys)
    trun = tpl.make_batched_client_epoch(CNNConfig(**SMALL), batch_size=B,
                                         threshold=0.5, l1=1e-5)
    tf, tl = trun(torch.from_numpy(flat), torch.from_numpy(x),
                  torch.from_numpy(v), lrs, None)
    assert float(jl.min()) > 0
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # and each row is that client's sequential epoch on its own data
    seq = tpl.make_client_epoch(CNNConfig(**SMALL), batch_size=B,
                                threshold=0.5, l1=1e-5)
    template = _init()
    for k, n in enumerate(SIZES):
        p = params_from_numpy(jsc.unflatten_like(flat[k], template), "cpu")
        p, o, _ = seq(p, tadam.adam_init(p), x[k, :n], float(lrs[k]), None)
        assert int(o["t"]) == -(-n // B)
        np.testing.assert_allclose(tsc.flatten_tree(p).numpy(), tf[k].numpy(),
                                   atol=ATOL, rtol=0)


def test_batched_epoch_uses_each_clients_masks():
    """With dropout on, the batched epoch given the stacked masks equals
    each client's sequential epoch given its own masks."""
    cfg = CNNConfig(conv_filters=(8, 8), hidden=16, dropout=0.3)
    flat = _stack((0, 1))
    x, v = _clients(sizes=(150, 60))
    gen = torch.Generator().manual_seed(3)
    masks = [tcnn.dropout_masks(cfg, (1, -(-n // B), B), gen)
             for n in (150, 60)]
    stacked = torch.ones((2, 1, 2, B, 16), dtype=torch.bool)
    for k, m in enumerate(masks):
        stacked[k, :, :m.shape[1]] = m
    lrs = np.array([1e-3, 2e-3], np.float32)
    tf, _ = tpl.make_batched_client_epoch(cfg, batch_size=B, threshold=0.5)(
        torch.from_numpy(flat), torch.from_numpy(x), torch.from_numpy(v),
        lrs, stacked)
    seq = tpl.make_client_epoch(cfg, batch_size=B, threshold=0.5)
    template = _init()
    for k, n in enumerate((150, 60)):
        p = params_from_numpy(jsc.unflatten_like(flat[k], template), "cpu")
        p, _, _ = seq(p, tadam.adam_init(p), x[k, :n], float(lrs[k]),
                      masks[k][0])
        np.testing.assert_allclose(tsc.flatten_tree(p).numpy(), tf[k].numpy(),
                                   atol=ATOL, rtol=0)
    assert not np.allclose(tf.numpy(), tpl.make_batched_client_epoch(
        cfg, batch_size=B, threshold=0.5)(
            torch.from_numpy(flat), torch.from_numpy(x), torch.from_numpy(v),
            lrs, None)[0].numpy())


def test_histogram_batch_matches_reference():
    flat = _stack((4, 5, 6))
    x, v = _clients(seed=6)
    want = jpl.class_histogram_batch(JCNN(**SMALL), batch_size=B)(
        jnp.asarray(flat), jnp.asarray(x), jnp.asarray(v))
    got = tpl.class_histogram_batch(CNNConfig(**SMALL), batch_size=B)(
        torch.from_numpy(flat), torch.from_numpy(x), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # padding rows are neither counted nor in the denominator
    seq = tpl.class_histogram(CNNConfig(**SMALL))
    template = _init()
    for k, n in enumerate(SIZES):
        p = params_from_numpy(jsc.unflatten_like(flat[k], template), "cpu")
        np.testing.assert_array_equal(
            got[k].numpy(), seq(p, torch.from_numpy(x[k, :n])).numpy())


def test_server_epoch_flat_matches_reference():
    init = _init()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((150, 78)).astype(np.float32) * 2
    y = rng.integers(0, 9, 150).astype(np.int32)
    flat = jsc.flatten_tree(init)
    jrun = jpl.make_server_epoch_flat(JCNN(**SMALL), batch_size=B, l1=1e-5)
    jf, jo, jl = jrun(flat, {"m": jnp.zeros_like(flat),
                             "v": jnp.zeros_like(flat),
                             "t": jnp.zeros((), jnp.int32)},
                      x, y, 1e-3, jax.random.PRNGKey(0))
    trun = tpl.make_server_epoch_flat(CNNConfig(**SMALL), batch_size=B,
                                      l1=1e-5)
    tflat = torch.tensor(np.asarray(flat))
    tf, to, tl = trun(tflat, tadam.adam_init_rows(tflat[None]), x, y, 1e-3,
                      None)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to["m"][0].numpy(), np.asarray(jo["m"]),
                               atol=1e-6, rtol=0)
    assert int(to["t"][0]) == int(jo["t"]) == 2
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)


@pytest.mark.parametrize("capacity", [None, 300])
def test_flat_blends_match_reference(capacity):
    """``blend_flat_csr`` from bases + CSR payloads (with a capacity that
    cuts rows) and ``blend_flat`` from the uploaded stack, against the
    reference's jnp blends, at float32 rounding."""
    rng = np.random.default_rng(7)
    base = _stack((0, 1, 2, 3))
    new = (base + rng.standard_normal(base.shape).astype(np.float32) * 1e-3)
    server = np.asarray(jsc.flatten_tree(_init(9)))
    w = np.array([0.1, 0.4, 0.3, 0.2])
    fw = 0.37
    jc = jsc.SparseComm("p0.2", use_kernel=False, capacity=capacity)
    (jv, ji), jst, jdec = jc.csr_core(False)(jnp.asarray(new),
                                             jnp.asarray(base))
    want = jagg.blend_flat_csr(jnp.asarray(server), jnp.asarray(base), jv,
                               ji, jnp.asarray(w, jnp.float32),
                               jnp.float32(fw))
    tc = tsc.SparseComm("p0.2", capacity=capacity)
    (tv, ti), tst, tdec = tc.csr_core(torch.from_numpy(new),
                                      torch.from_numpy(base))
    got = tagg.blend_flat_csr(torch.from_numpy(server),
                              torch.from_numpy(base), tv, ti, tst, w, fw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                               rtol=1e-6)
    if capacity:
        assert int(tst.max()) == capacity
    up = np.asarray(jnp.asarray(base) + jdec)
    want = jagg._blend_flat(jnp.asarray(server), jnp.asarray(up),
                            jnp.asarray(w, jnp.float32), jnp.float32(fw))
    got = tagg.blend_flat(torch.from_numpy(server), torch.from_numpy(up), w,
                          fw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                               rtol=1e-6)


# -- whole trainers --------------------------------------------------------
SCALE, ROUNDS, SEED = 0.0015, 2, 0
WIRES = {"csr": dict(wire_format="csr"),
         "dense_masked": dict(wire_format="dense_masked"),
         "disabled": dict(sparse_comm=False)}


@functools.lru_cache(maxsize=None)
def _reference(wire):
    """The reference's sequential engine on ``wire`` and its initial
    weights (its ``_init_models`` draws them from the second half of
    ``split(PRNGKey(seed))``)."""
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    init = {n: np.asarray(v) for n, v in jcnn.init_cnn(JCNN(**SMALL),
                                                       k).items()}
    ref = JTrainer(j_make_dataset("basic", scale=SCALE, seed=SEED),
                   JConfig(rounds=ROUNDS, cnn=JCNN(**SMALL), seed=SEED,
                           engine="sequential", use_kernels=False,
                           **WIRES[wire]))
    return init, ref, ref.train()


def _check_against_reference(port, got, ref, want):
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
    assert got["fleet"] == want["fleet"] and got["rounds"] == want["rounds"]
    assert got["art"] == want["art"]
    assert port.store.bytes() == ref.store.bytes()   # detach flags too


@pytest.mark.parametrize("engine,wire", [
    ("batched", "csr"), ("batched", "dense_masked"), ("batched", "disabled"),
    ("sequential", "dense_masked"), ("sequential", "disabled")])
def test_trainer_matches_reference_sequential_engine(engine, wire):
    init, ref, want = _reference(wire)
    port = FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                         FedS3AConfig(rounds=ROUNDS, cnn=CNNConfig(**SMALL),
                                      seed=SEED, device="cpu", engine=engine,
                                      **WIRES[wire]),
                         init_params=init)
    assert port.engine == engine
    got = port.train()
    _check_against_reference(port, got, ref, want)
    if wire == "disabled":
        assert got["aco"] == want["aco"] == 1.0
        assert port.comm.wire_breakdown() == ref.comm.wire_breakdown()


def test_engine_selection():
    data = make_dataset("basic", scale=SCALE, seed=SEED)
    small = FedS3ATrainer(data, FedS3AConfig(cnn=CNNConfig(**SMALL),
                                             device="cpu",
                                             init_server_epochs=0))
    assert small.engine == "batched"
    big = FedS3ATrainer(data, FedS3AConfig(device="cpu",
                                           init_server_epochs=0))
    assert big.engine == "sequential"           # 5,213,449 parameters
    with pytest.raises(ValueError, match="engine"):
        FedS3ATrainer(data, FedS3AConfig(cnn=CNNConfig(**SMALL),
                                         device="cpu", engine="vmapped"))

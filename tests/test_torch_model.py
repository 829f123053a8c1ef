"""The port's CNN, Adam and pseudo-label epochs against the JAX package on
the CPU, from the same parameters, at a reduced width with dropout 0
(the two packages draw different random bits). Tolerance atol 1e-5: the
products are float32 matmuls summed in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import pseudo_label as jpl  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optimizer import adam as jadam  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import pseudo_label as tpl  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.optimizer import adam as tadam  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402,E501

SMALL = dict(conv_filters=(8, 8), hidden=16, dropout=0.0)
ATOL = 1e-5


def _init(seed=0):
    p = jcnn.init_cnn(JCNN(**SMALL), jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in p.items()}


def _data(n, seed=0, labels=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 78)).astype(np.float32) * 2
    return (x, rng.integers(0, 9, n).astype(np.int32)) if labels else x


def _close(a, b, atol=ATOL):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("cfg", [SMALL, {}])
def test_param_count_and_layout(cfg):
    jc, tc = JCNN(**cfg), CNNConfig(**cfg)
    assert jcnn.cnn_param_count(jc) == tcnn.cnn_param_count(tc)
    jp = jax.eval_shape(lambda k: jcnn.init_cnn(jc, k),
                        jax.random.PRNGKey(0))
    tp = tcnn.init_cnn(tc, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in jp.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    if not cfg:
        assert tcnn.cnn_param_count(tc) == 5_213_449


def test_cnn_forward_matches():
    init = _init()
    x = _data(37)
    want = jcnn.cnn_forward(JCNN(**SMALL), init, jnp.asarray(x))
    got = tcnn.cnn_forward(CNNConfig(**SMALL), params_from_numpy(init, "cpu"),
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_adam_update_matches():
    init = _init()
    rng = np.random.default_rng(1)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
             for k, v in init.items()}
    jp, jo = init, jadam.adam_init(init)
    tp = params_from_numpy(init, "cpu")
    to = tadam.adam_init(tp)
    for _ in range(3):
        jp, jo = jadam.adam_update(grads, jo, jp, lr=1e-3, l1=1e-5)
        tp, to = tadam.adam_update(params_from_numpy(grads, "cpu"), to, tp,
                                   lr=1e-3, l1=1e-5)
    assert int(to["t"]) == int(jo["t"]) == 3
    _close(params_to_numpy(tp), jp, atol=1e-6)
    _close(params_to_numpy(to["m"]), jo["m"], atol=1e-6)
    _close(params_to_numpy(to["v"]), jo["v"], atol=1e-6)


def test_client_epoch_matches():
    """One pseudo-label epoch over a padded client (3 batches, the last
    partial), threshold 0.5 so that rows pass the mask; the reference runs
    its Pallas loss in interpret mode."""
    init = _init()
    x = _data(237, seed=2)
    j_epoch = jpl.make_client_epoch(JCNN(**SMALL), batch_size=100,
                                    threshold=0.5, l1=1e-5, use_kernel=True)
    jp, jo, jl = j_epoch(init, jadam.adam_init(init), x, 1e-3,
                         jax.random.PRNGKey(0))
    t_epoch = tpl.make_client_epoch(CNNConfig(**SMALL), batch_size=100,
                                    threshold=0.5, l1=1e-5)
    tp = params_from_numpy(init, "cpu")
    tp, to, tl = t_epoch(tp, tadam.adam_init(tp), x, 1e-3, None)
    assert float(jl) > 0
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    _close(params_to_numpy(tp), jp)
    assert int(to["t"]) == int(jo["t"]) == 3


def test_server_epoch_matches():
    init = _init()
    x, y = _data(150, seed=3, labels=True)
    j_epoch = jpl.make_server_epoch(JCNN(**SMALL), batch_size=100, l1=1e-5)
    jp, _, jl = j_epoch(init, jadam.adam_init(init), x, y, 1e-3,
                        jax.random.PRNGKey(0))
    t_epoch = tpl.make_server_epoch(CNNConfig(**SMALL), batch_size=100,
                                    l1=1e-5)
    tp = params_from_numpy(init, "cpu")
    tp, _, tl = t_epoch(tp, tadam.adam_init(tp), x, y, 1e-3, None)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    _close(params_to_numpy(tp), jp)


def test_predict_and_histogram_match():
    init = _init(seed=4)
    x = _data(91, seed=4)
    jc, tc = JCNN(**SMALL), CNNConfig(**SMALL)
    tp = params_from_numpy(init, "cpu")
    np.testing.assert_array_equal(
        tpl.predict_fn(tc)(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jpl.predict_fn(jc)(init, jnp.asarray(x))))
    np.testing.assert_array_equal(
        tpl.class_histogram(tc)(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jpl.class_histogram(jc)(init, jnp.asarray(x))))


def test_dropout_draws_from_the_generator():
    cfg = CNNConfig(conv_filters=(8, 8), hidden=16, dropout=0.5)
    p = params_from_numpy(_init(), "cpu")
    x = torch.from_numpy(_data(8))

    def run(seed):
        mask = tcnn.dropout_masks(cfg, (8,),
                                  torch.Generator().manual_seed(seed))
        assert mask.shape == (8, 16) and mask.dtype == torch.bool
        return tcnn.cnn_forward(cfg, p, x, mask=mask)
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert tcnn.dropout_masks(CNNConfig(**SMALL), (8,),
                              torch.Generator()) is None
    assert torch.equal(tcnn.cnn_forward(cfg, p, x),
                       tcnn.cnn_forward(cfg, p, x, mask=None))

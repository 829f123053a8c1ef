"""The model adapters and the LM path's pieces on the CPU against the
reference:

* every ``LMAdapter`` closure against the reference's ``_lm_suite``
  closure on the same inputs (float32: losses and histograms within 1e-5,
  parameters within 1e-5 but for a few Adam sign flips, predictions
  exact; one bf16 client step's loss, and its gradient in norm, within
  ``test_torch_lm.py``'s bf16 bound, 3e-2, against the reference's
  kernel route);
* the LM's tree epoch (sequential engine) against its flat epoch (batched
  engine, one client after another): the same bits;
* ``CNNAdapter`` against the CNN factories, bit for bit;
* ``make_lm_dataset`` array-equal to the reference's;
* the plain ``masked_pseudo_ce`` forward and gradient above 1024 classes
  (the float64 exp sum) against the reference's Pallas kernel in interpret
  mode and its custom VJP, with confident rows planted, and the plain
  branch at C <= 1024 unchanged (``torch.softmax``'s bits).

The reduced qwen2 is ``benchmarks/bench_fleet.py``'s ``lm-small`` shape at
V = 512. Eq. 5's threshold is 1e-3 in the closure tests, below every
row's largest probability (>= 1/512), so that every row trains."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import load_all as jload_all  # noqa: E402
from repro.core import model_adapter as jma  # noqa: E402
from repro.core import sparse_comm as jcomm  # noqa: E402
from repro.data.synthetic_lm import make_lm_dataset as j_make_lm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optimizer import adam_init as j_adam_init  # noqa: E402
from repro_torch.configs import get_config, load_all  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import model_adapter, pseudo_label  # noqa: E402
from repro_torch.core import sparse_comm  # noqa: E402
from repro_torch.data import make_lm_dataset  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.cnn import init_cnn  # noqa: E402
from repro_torch.optimizer import adam_init, adam_init_rows  # noqa: E402
from repro_torch.tree import leaves as tree_leaves  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

LM_SMALL = dict(num_layers=1, d_model=128, d_ff=256, num_heads=2,
                num_kv_heads=1)
DATA = dict(vocab_size=512, seq_len=16, num_classes=8)
B, THETA, L1, LR = 16, 1e-3, 1e-5, 5e-4
TOL, BF16 = 1e-5, 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(dtype="float32"):
    jload_all()
    load_all()
    return (jget_config("qwen2-1.5b").reduced(dtype=dtype, **LM_SMALL),
            get_config("qwen2-1.5b").reduced(dtype=dtype, **LM_SMALL))


@pytest.fixture(scope="module")
def lm():
    """(reference suite, port adapter, reference params, port params,
    data) at float32."""
    jcfg, cfg = _cfgs()
    suite = jma._lm_suite(jcfg, B, THETA, L1, False, 1)
    pa = model_adapter.make_adapter(cfg, batch_size=B, threshold=THETA,
                                    l1=L1, epochs=1)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return suite, pa, jp, tp, make_lm_dataset(4, **DATA, seed=1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# Adam turns a near-zero gradient's rounding into a full step of either
# sign: a few parameters may sit up to 2 lr a step apart (2 of 213,632 did
# in one client epoch, by 5.3e-5)
FLIPS, FLIP_STEP = 16, 2 * LR * 4


def _close_params(got, want):
    got, want = np.asarray(got), np.asarray(want)
    far = ~np.isclose(got, want, atol=TOL, rtol=TOL)
    assert far.sum() <= FLIPS * got.reshape(-1, got.shape[-1]).shape[0], \
        far.sum()
    assert np.abs(got - want).max() <= FLIP_STEP


def test_client_epoch(lm):
    suite, pa, jp, tp, data = lm
    x = data["clients"][0]["x"]
    a, aopt, aloss = suite["client_epoch"](jp, j_adam_init(jp), x, LR,
                                           jax.random.PRNGKey(0))
    b, bopt, bloss = pa.client_epoch(tp, adam_init(tp), x, LR)
    _close(bloss, aloss)
    _close_params(sparse_comm.flatten_tree(b), jcomm.flatten_tree(a))
    assert int(bopt["t"]) == int(aopt["t"]) == -(-len(x) // B)
    assert float(bloss) > 0          # every row confident: Eq. 5 trains


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
def test_server_epoch(lm, flat):
    suite, pa, jp, tp, data = lm
    x, y = data["server"]["x"], data["server"]["y"]
    if flat:
        jf = jcomm.flatten_tree(jp)
        a, _, aloss = suite["server_epoch_flat"](
            jf, j_adam_init(jf), x, y, LR, jax.random.PRNGKey(0))
        tf = sparse_comm.flatten_tree(tp)
        b, _, bloss = pa.server_epoch_flat(tf, adam_init_rows(tf[None]), x,
                                           y, LR)
        _close_params(b, a)
    else:
        a, _, aloss = suite["server_epoch"](jp, j_adam_init(jp), x, y, LR,
                                            jax.random.PRNGKey(0))
        b, _, bloss = pa.server_epoch(tp, adam_init(tp), x, y, LR)
        _close_params(sparse_comm.flatten_tree(b), jcomm.flatten_tree(a))
    _close(bloss, aloss)


def _stack(data, ids):
    """The trainer's padded (K, nb*B, S) data and (K, nb*B) validity."""
    clients = [data["clients"][i] for i in ids]
    nb = max(-(-len(c["x"]) // B) for c in clients)
    x = np.zeros((len(ids), nb * B, DATA["seq_len"]), np.float32)
    v = np.zeros((len(ids), nb * B), np.float32)
    for k, c in enumerate(clients):
        x[k, :len(c["x"])] = c["x"]
        v[k, :len(c["x"])] = 1.0
    return x, v


def test_batched_epoch(lm):
    suite, pa, jp, tp, data = lm
    x, v = _stack(data, [0, 1, 3])
    jf = jnp.stack([jcomm.flatten_tree(jp)] * 3)
    lrs = np.array([LR, 0.5 * LR, 2 * LR], np.float32)
    a, aloss = suite["batched_epoch"](jf, jnp.asarray(x), jnp.asarray(v), lrs,
                                      jax.random.split(jax.random.PRNGKey(0),
                                                       3))
    tf = torch.stack([sparse_comm.flatten_tree(tp)] * 3)
    b, bloss = pa.batched_epoch(tf, torch.as_tensor(x), torch.as_tensor(v),
                                lrs)
    _close_params(b, a)
    _close(bloss, aloss)


def test_tree_and_flat_client_epochs_give_the_same_bits(lm):
    """The sequential engine's tree epoch and the batched engine's flat
    one take the same Adam steps on the same gradients."""
    _, pa, _, tp, data = lm
    x, v = _stack(data, [2])
    tree, _, _ = pa.client_epoch(tp, adam_init(tp), data["clients"][2]["x"],
                                 LR)
    flat, _ = pa.batched_epoch(sparse_comm.flatten_tree(tp)[None],
                               torch.as_tensor(x), torch.as_tensor(v), [LR])
    assert torch.equal(sparse_comm.flatten_tree(tree), flat[0])


def test_predict_and_histograms(lm):
    suite, pa, jp, tp, data = lm
    xt = data["test"]["x"]
    np.testing.assert_array_equal(
        pa.predict(tp, torch.as_tensor(xt)).numpy(),
        np.asarray(suite["predict"](jp, jnp.asarray(xt))))
    x0 = data["clients"][0]["x"]
    _close(pa.histogram(tp, torch.as_tensor(x0)),
           suite["histogram"](jp, jnp.asarray(x0)))
    x, v = _stack(data, [0, 2])
    jf = jnp.stack([jcomm.flatten_tree(jp)] * 2)
    tf = torch.stack([sparse_comm.flatten_tree(tp)] * 2)
    _close(pa.histogram_batch(tf, torch.as_tensor(x), torch.as_tensor(v)),
           suite["histogram_batch"](jf, jnp.asarray(x), jnp.asarray(v)))


def test_adapter_contract(lm):
    _, pa, jp, tp, _ = lm
    jcfg, cfg = _cfgs()
    ja = jma.make_adapter(jcfg, batch_size=B, threshold=THETA, l1=L1,
                          use_kernel=False, epochs=1)
    assert (pa.kind, pa.num_classes, pa.param_count()) == \
        (ja.kind, ja.num_classes, ja.param_count())
    shapes = [tuple(t.shape) for t in jax.tree.leaves(ja.template)]
    assert [tuple(t.shape) for t in tree_leaves(pa.template)] \
        == shapes
    assert all(t.device.type == "meta"
               for t in tree_leaves(pa.template))
    drawn = pa.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(drawn)] == shapes


def test_bf16_client_step():
    """One pseudo-label step's loss and gradient in bf16 compute, against
    the reference's kernel route (the Pallas kernel in interpret mode and
    its custom VJP, whose one-hot takes the first of tied maxima, as the
    port's backward does). bf16 logits often tie at the top: the
    reference's plain route differentiates ``jnp.max``, which splits the
    gradient between tied maxima, and lies twice as close to the float32
    gradient as either one-hot (0.161 against 0.322 of its norm here)."""
    jcfg, cfg = _cfgs("bfloat16")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pa = model_adapter.make_adapter(cfg, batch_size=B, threshold=THETA,
                                    l1=L1, epochs=1)
    x = make_lm_dataset(4, **DATA, seed=1)["clients"][0]["x"][:B]
    v = np.ones(B, np.float32)
    aloss, agrad = jax.value_and_grad(
        lambda p: jma._lm_pseudo_loss(jcfg, p, jnp.asarray(x),
                                      jnp.asarray(v), threshold=THETA,
                                      use_kernel=True))(jp)
    bloss, bgrad = model_adapter._value_and_grad(
        lambda p: pa._pseudo_loss(p, torch.as_tensor(x), torch.as_tensor(v)),
        tp)
    _close(bloss, aloss, BF16)
    got = model_adapter._flat_grad(bgrad).numpy()
    want = np.asarray(jcomm.flatten_tree(agrad))
    # bf16 roundings fall differently element by element: the gradient as
    # a whole within the bound
    assert np.linalg.norm(got - want) <= BF16 * np.linalg.norm(want)


def test_cnn_adapter_is_the_factories():
    cnn = CNNConfig(conv_filters=(8, 8), hidden=16)
    kw = dict(batch_size=20, threshold=0.5, l1=1e-5)
    ad = model_adapter.make_adapter(cnn, epochs=1, **kw)
    assert ad.kind == "cnn" and ad.num_classes == cnn.num_classes
    params = init_cnn(cnn, torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal((50, 78)).astype(np.float32)
    masks = torch.ones((3, 20, 16), dtype=torch.bool)
    a = ad.client_epoch(params, adam_init(params), x, 1e-3, masks)
    b = pseudo_label.make_client_epoch(cnn, **kw)(params, adam_init(params),
                                                  x, 1e-3, masks)
    assert torch.equal(sparse_comm.flatten_tree(a[0]),
                       sparse_comm.flatten_tree(b[0]))
    assert torch.equal(a[2], b[2])
    xt = torch.as_tensor(x)
    assert torch.equal(ad.histogram(params, xt),
                       pseudo_label.class_histogram(cnn)(params, xt))
    assert torch.equal(ad.predict(params, xt),
                       pseudo_label.predict_fn(cnn)(params, xt))
    assert ad.param_count() == sparse_comm.flatten_tree(params).numel()


@pytest.mark.parametrize("seed, pool", [(0, None), (4, None), (2, 3)])
def test_lm_dataset_is_the_references(seed, pool):
    kw = dict(DATA, num_clients=7, seed=seed, pool=pool)
    a, b = make_lm_dataset(**kw), j_make_lm(**kw)
    for split in ("server", "test"):
        for k in ("x", "y"):
            np.testing.assert_array_equal(a[split][k], b[split][k])
    assert len(a["clients"]) == len(b["clients"]) == 7
    for ca, cb in zip(a["clients"], b["clients"]):
        np.testing.assert_array_equal(ca["x"], cb["x"])
        np.testing.assert_array_equal(ca["y"], cb["y"])
    np.testing.assert_array_equal(a["counts"], b["counts"])
    np.testing.assert_array_equal(a["entropy"], b["entropy"])
    assert a.get("pool") == b.get("pool")


# -- masked_pseudo_ce above 1024 classes ------------------------------------
# against the reference's Pallas kernel (interpret mode, a float32 sum) and
# custom VJP, measured over seeds 0-2 at C = 1025, 4096, 151,936: the masks
# equal; the loss within 1.91e-6 (an ulp of the largest logit, from which
# max_logp = m - (m + log s) cancels), the gradient within 8.3e-7 (the
# float32 sum's rounding in p next to the float64 one's)
WIDE_LOSS, WIDE_GRAD = 4e-6, 2e-6


def _planted(c, n=16, seed=0, theta=0.95):
    """(n, c) logits with every other row confident: one logit raised
    until its softmax probability passes ``theta`` by a margin."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c)).astype(np.float32)
    for r in range(0, n, 2):
        x[r, rng.integers(c)] += np.log(c) + 5.0
    return x


@pytest.mark.parametrize("c", [1025, 4096, 151_936])
def test_wide_plain_version_against_the_pallas_kernel(c):
    x = _planted(c)
    loss, mask = ref.masked_pseudo_ce_ref(torch.as_tensor(x), 0.95)
    jl, jm = jops.masked_pseudo_ce(jnp.asarray(x), 0.95)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert mask.sum() == 8
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), atol=WIDE_LOSS,
                               rtol=0)
    g = np.linspace(0.5, 1.5, 16).astype(np.float32)
    jgrad = jax.grad(lambda z: jnp.sum(jops.masked_pseudo_ce(z, 0.95)[0]
                                       * g))(jnp.asarray(x))
    grad = ref.masked_pseudo_ce_grad(torch.as_tensor(x), mask,
                                     torch.as_tensor(g))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad),
                               atol=WIDE_GRAD, rtol=0)
    assert np.count_nonzero(grad.numpy()[1::2]) == 0
    # the wrapper on the CPU is the plain version, through autograd too
    xt = torch.as_tensor(x).requires_grad_(True)
    lt, _ = ops.masked_pseudo_ce(xt, 0.95)
    (gt,) = torch.autograd.grad(torch.sum(lt * torch.as_tensor(g)), xt)
    assert torch.equal(gt, grad)


@pytest.mark.parametrize("c", [1025, 151_936])
def test_wide_plain_version_sums_in_float64(c):
    x = torch.as_tensor(_planted(c, seed=1))
    m = x.max(dim=1).values
    e = torch.exp(x - m[:, None])
    s = e.double().sum(dim=1).float()
    loss, mask = ref.masked_pseudo_ce_ref(x, 0.95)
    max_logp = m - (m + torch.log(s))
    assert torch.equal(loss, -mask * max_logp)
    g = torch.ones(x.shape[0])
    want = (e / s[:, None] - torch.nn.functional.one_hot(
        x.argmax(dim=1), c).float()) * (mask * g)[:, None]
    assert torch.equal(ref.masked_pseudo_ce_grad(x, mask, g), want)


@pytest.mark.parametrize("c", [9, 1024])
def test_narrow_plain_version_unchanged(c):
    """At C <= 1024 the plain versions are torch.softmax and a float32
    sum, as before the wide branch."""
    x = torch.as_tensor(_planted(c, seed=2))
    m = x.max(dim=1).values
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(dim=1))
    mask = (m - lse >= ref.log_threshold(0.95)).float()
    loss, got_mask = ref.masked_pseudo_ce_ref(x, 0.95)
    assert torch.equal(loss, -mask * (m - lse)) and \
        torch.equal(got_mask, mask)
    g = torch.linspace(0.5, 1.5, x.shape[0])
    want = (torch.softmax(x, dim=1) - torch.nn.functional.one_hot(
        x.argmax(dim=1), c).float()) * (mask * g)[:, None]
    assert torch.equal(ref.masked_pseudo_ce_grad(x, mask, g), want)


@pytest.mark.parametrize("c", [9, 1025])
def test_bf16_logits_against_the_reference(c):
    """bf16 logits: ``ops.masked_pseudo_ce`` casts them to float32 once,
    as the reference's kernel does, and returns the gradient in bf16, as
    its custom VJP does. Loss and mask against the Pallas kernel in
    interpret mode on the same bf16 input; the gradient, through autograd
    and through ``masked_pseudo_ce_grad``, against the reference's VJP
    within the float32 bound above and one bf16 rounding of it."""
    xb = torch.as_tensor(_planted(c, seed=3)).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    g = np.linspace(0.5, 1.5, xb.shape[0]).astype(np.float32)
    xt = xb.clone().requires_grad_(True)
    loss, mask = ops.masked_pseudo_ce(xt, 0.95)
    (grad,) = torch.autograd.grad(torch.sum(loss * torch.as_tensor(g)), xt)
    jl, jm = jops.masked_pseudo_ce(jx, 0.95)
    jgrad = jax.grad(lambda z: jnp.sum(jops.masked_pseudo_ce(z, 0.95)[0]
                                       * g))(jx)
    assert loss.dtype == mask.dtype == torch.float32
    assert grad.dtype == torch.bfloat16 and jgrad.dtype == jnp.bfloat16
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert 0 < int(mask.sum()) < xb.shape[0]
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl),
                               atol=WIDE_LOSS, rtol=0)
    want = np.asarray(jgrad.astype(jnp.float32))
    got = grad.float().numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    assert np.all(np.abs(got - want) <= WIDE_GRAD + ulp)
    alone = ops.masked_pseudo_ce_grad(xb, mask, torch.as_tensor(g))
    assert alone.dtype == torch.bfloat16 and torch.equal(alone, grad)
    # the plain versions on the float32 cast, the same bits
    assert torch.equal(loss, ref.masked_pseudo_ce_ref(xb.float(), 0.95)[0])
    assert torch.equal(grad, ref.masked_pseudo_ce_grad(
        xb.float(), mask, torch.as_tensor(g)).to(torch.bfloat16))


def test_lm_configs_agree():
    jcfg, cfg = _cfgs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)

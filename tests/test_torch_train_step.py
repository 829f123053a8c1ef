"""The port's LM training step (``training/steps.py`` ``lm_loss`` and
``make_train_step``) against the reference's, on the CPU.

Model: qwen2-1.5b cut to ``benchmarks/bench_fleet.py``'s ``lm-small``
shape (1 layer, d 128, d_ff 256, 2 / 1 heads of 64), V = 512, float32,
from the reference's own initial parameters carried over with
``weights.tree_from_numpy``; the same numpy tokens (B 4, S 32) on both
sides; ``qblk = kblk = 16`` through ``FLASH_BLOCKS`` on both sides, so
``impl="flash"`` runs a 2 x 2 grid of tiles. Cases: ``impl`` ref and
flash x 1 and 2 microbatches, a ``loss_mask`` case and an ``l1`` case;
2 steps at lr 1e-3 each.

Bounds: the first step's gradients (read from Adam's first moment,
``m = 0.1 g`` after one step, so the microbatched sums are held too)
within 1e-5 of the reference's in relative L2 norm per leaf; the 2 steps'
losses within 1e-5; the parameters within atol 1e-4 / rtol 1e-3, except
elements whose Adam step flipped sign between the packages (a gradient
within rounding of zero): those may differ by at most 2 x lr x steps, and
are counted, at most 0.1% of the parameters. Measured: gradients 1.0e-6 -
1.5e-6 apart, losses at most 1.5e-7, parameters at most 1.26e-4 (the l1
case; 3.1e-5 - 8.5e-5 in the others) and no element past atol / rtol.

Also: ``remat`` on and off give the port the same gradients bit for bit
(2 layers, so the stacked layers exist), and the backward does run the
stacked layers again."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optimizer import adam_init as jadam_init  # noqa: E402
from repro.training.steps import make_train_step as jmake_train_step  # noqa: E402,E501
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import blocks as PB  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optimizer import adam_init  # noqa: E402
from repro_torch.training import steps  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import tree_from_numpy  # noqa: E402

LM_SMALL = dict(num_layers=1, d_model=128, d_ff=256, num_heads=2,
                num_kv_heads=1, dtype="float32")
B, S, BLK, LR, STEPS = 4, 32, 16, 1e-3, 2
GRAD_REL, LOSS_TOL, ATOL, RTOL = 1e-5, 1e-5, 1e-4, 1e-3

CASES = {
    "ref-mb1": dict(impl="ref", mb=1),
    "ref-mb2": dict(impl="ref", mb=2),
    "flash-mb1": dict(impl="flash", mb=1),
    "flash-mb2": dict(impl="flash", mb=2),
    "flash-loss_mask": dict(impl="flash", mb=2, loss_mask=True),
    "ref-l1": dict(impl="ref", mb=1, l1=1e-3),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _blocks(monkeypatch):
    for blocks in (JL.FLASH_BLOCKS, L.FLASH_BLOCKS):
        monkeypatch.setitem(blocks, "qblk", BLK)
        monkeypatch.setitem(blocks, "kblk", BLK)


def _cfgs(**kw):
    kw = {**LM_SMALL, **kw}
    return (jget_config("qwen2-1.5b").reduced(**kw),
            get_config("qwen2-1.5b").reduced(**kw))


def _init(jcfg):
    return jax.tree.map(np.asarray, jlm.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))


def _batches(loss_mask, V=512):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32)}
        if loss_mask:
            b["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.int32)
        out.append(b)
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_the_reference(case):
    c = CASES[case]
    jcfg, cfg = _cfgs()
    init = _init(jcfg)
    kw = dict(lr=LR, num_microbatches=c["mb"], impl=c["impl"],
              l1=c.get("l1", 0.0))
    jstep = jax.jit(jmake_train_step(jcfg, **kw))
    step = steps.make_train_step(cfg, **kw)
    jp = jax.tree.map(jnp.asarray, init)
    jopt = jadam_init(jp)
    p = tree_from_numpy(init, "cpu")
    opt = adam_init(p)
    jlosses, losses = [], []
    for i, b in enumerate(_batches(c.get("loss_mask", False))):
        jp, jopt, jl = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        p, opt, loss = step(p, opt, {k: torch.as_tensor(v, dtype=torch.int64)
                                     for k, v in b.items()})
        jlosses.append(float(jl))
        losses.append(float(loss))
        if i == 0:    # Adam's first moment after one step: 0.1 x gradient
            for a, w in zip(leaves(opt["m"]), jax.tree.leaves(jopt["m"])):
                assert _rel(a.numpy(), np.asarray(w)) <= GRAD_REL
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert all(np.isfinite(losses))
    flips = 0
    for a, w in zip(leaves(p), jax.tree.leaves(jp)):
        a, w = a.numpy(), np.asarray(w)
        off = np.abs(a - w) > ATOL + RTOL * np.abs(w)
        flips += int(off.sum())
        assert np.abs(a - w)[off].max(initial=0.0) <= 2 * LR * STEPS
    n = sum(t.numel() for t in leaves(p))
    assert flips <= n // 1000, f"{flips} of {n} parameters past atol/rtol"


def test_lm_loss_matches_the_reference_with_flash_and_ref():
    """``lm_loss`` alone (no Adam): ``flash`` and ``ref`` each against the
    reference's, and the two within 1e-5 of each other."""
    from repro.training.steps import lm_loss as jlm_loss
    jcfg, cfg = _cfgs()
    init = _init(jcfg)
    b = _batches(False)[0]
    got = {}
    for impl in ("ref", "flash"):
        want = float(jax.jit(lambda p, t: jlm_loss(jcfg, p, {"tokens": t},
                                                   impl=impl))(
            jax.tree.map(jnp.asarray, init), jnp.asarray(b["tokens"])))
        got[impl] = float(steps.lm_loss(
            cfg, tree_from_numpy(init, "cpu"),
            {"tokens": torch.as_tensor(b["tokens"])}, impl=impl))
        assert abs(got[impl] - want) <= LOSS_TOL * abs(want)
    assert abs(got["flash"] - got["ref"]) <= LOSS_TOL * abs(got["ref"])


def test_remat_gives_the_same_gradients(monkeypatch):
    jcfg, cfg = _cfgs(num_layers=2)
    assert lm.scan_plan(cfg) == (0, 1, 2)
    params = tree_from_numpy(_init(jcfg), "cpu")
    batch = {"tokens": torch.as_tensor(_batches(False)[0]["tokens"])}
    calls = []
    apply_block = PB.apply_block
    monkeypatch.setattr(PB, "apply_block", lambda *a, **kw: calls.append(1)
                        or apply_block(*a, **kw))
    grads = {}
    for remat in (False, True):
        calls.clear()
        loss, grads[remat] = steps.value_and_grad(
            lambda p: steps.lm_loss(cfg, p, batch, impl="flash",
                                    remat=remat), params)
        # two stacked layers, each run again in the backward under remat
        assert len(calls) == (4 if remat else 2)
    assert all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))


@pytest.mark.parametrize("rows,microbatches", [(6, 4), (2, 4)])
def test_indivisible_batch_raises(rows, microbatches):
    """Rows that do not split into the microbatches raise, as the
    reference's reshape does, instead of training on part of the batch
    (6 rows in 4) or on empty microbatches (2 rows in 4)."""
    jcfg, cfg = _cfgs()
    params = tree_from_numpy(_init(jcfg), "cpu")
    step = steps.make_train_step(cfg, num_microbatches=microbatches)
    batch = {"tokens": torch.zeros((rows, S), dtype=torch.int64)}
    with pytest.raises(ValueError, match="does not split"):
        step(params, adam_init(params), batch)
    jstep = jmake_train_step(jcfg, num_microbatches=microbatches)
    jp = jax.tree.map(jnp.asarray, _init(jcfg))
    with pytest.raises(TypeError, match="reshape"):
        jstep(jp, jadam_init(jp), {"tokens": jnp.zeros((rows, S),
                                                        jnp.int32)})


def test_moe_impl_raises():
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*queue 3b"):
        steps.make_train_step(cfg, moe_impl="sort")


def test_lm_loss_refuses_vision_patches():
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, num_vision_patches=4)
    params = lm.init_params(_cfgs()[1], torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int64),
             "patches": torch.zeros((1, 4, 128))}
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*queue 3b"):
        steps.lm_loss(cfg, params, batch)

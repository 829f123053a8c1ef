"""The port's dense language model and its serving path against the JAX
package, on the CPU, at the reduced qwen2-1.5b (2 layers, d 256, 4 / 2
heads, hd 64, V 512). Both start from the reference's own initial
parameters, carried over leaf by leaf with ``weights.tree_from_numpy``,
and take the same numpy token ids.

Tolerances: float32 pieces within 1e-5 (layers) and 1e-4 (whole models,
logits), since the packages sum products in other orders. bf16 pieces
within a few bf16 ulps (3e-2 on values of magnitude ~1, an ulp there
being 2^-7): the two frameworks' bf16 matrix products round their float32
sums identically but add them in other orders, so single elements land
one ulp apart and the difference carries through the layers (measured:
9.8e-3 on the last logits). Each implementation is held against its own
counterpart (``ref`` against ``ref``, ``pallas`` against ``pallas``):
the reference's ``_sdpa`` rounds its logits to bf16 and the flash kernel
does not, so the two differ by more than either does from its twin."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.training.steps import make_serve_step as jmake_serve_step  # noqa: E402,E501
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.training import steps  # noqa: E402
from repro_torch.weights import tree_from_numpy, tree_to_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-1.5b"
F32_LAYER, F32_MODEL, BF16 = 1e-5, 1e-4, 3e-2
SIG = ("attn", False)


def _cfgs(dtype):
    return (jget_config(ARCH).reduced(dtype=dtype),
            get_config(ARCH).reduced(dtype=dtype))


@pytest.fixture(scope="module")
def params():
    """The reference's initial parameters (param dtype float32 whatever
    the compute dtype) as (jax tree, port tree)."""
    jcfg, _ = _cfgs("float32")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def _tol(dtype, f32=F32_MODEL):
    return f32 if dtype == "float32" else BF16


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _x(seed, shape, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a, jnp.dtype(dtype)),
            torch.tensor(a).to(L.DTYPES[dtype]))


def _tokens(seed, B, S, V=512):
    t = np.random.default_rng(seed).integers(0, V, (B, S))
    return {"tokens": jnp.asarray(t, jnp.int32)}, {"tokens": torch.as_tensor(t)}


def _first_block(jp, tp):
    return (jax.tree.map(lambda t: t[0], jp["scan"]["pos_0"]),
            lm._index(tp["scan"]["pos_0"], 0))


# -- configs ---------------------------------------------------------------
def test_config_matches_the_reference():
    jc, c = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert dataclasses.asdict(c.reduced()) == dataclasses.asdict(jc.reduced())
    assert c.param_count() == jc.param_count() == 1_543_655_424
    assert c.layer_pattern() == jc.layer_pattern()
    assert lm.scan_plan(c) == jlm.scan_plan(jc) == (0, 1, 28)
    assert list_configs() == [ARCH]
    with pytest.raises(KeyError):
        get_config("llama4-maverick-400b-a17b")


def test_parameter_tree_is_the_reference_tree(params):
    jp, tp = params
    _, cfg = _cfgs("float32")
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), jp)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)
                                   .replace("torch.", "")), mine) == shapes
    back = tree_to_numpy(tp)
    assert all(np.array_equal(a, np.asarray(b)) and a.dtype == np.float32
               for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)))


# -- layers ----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope(dtype):
    jcfg, cfg = _cfgs(dtype)
    jx, tx = _x(0, (2, 16, 256), dtype)
    scale = np.random.default_rng(1).standard_normal(256).astype(np.float32)
    _close(L.rmsnorm(cfg, {"scale": torch.tensor(scale)}, tx),
           JL.rmsnorm(jcfg, {"scale": jnp.asarray(scale)}, jx),
           _tol(dtype, F32_LAYER))
    jq, tq = _x(2, (2, 16, 4, 64), dtype)
    pos = np.tile(np.arange(16), (2, 1))
    _close(L.apply_rope(cfg, tq, torch.as_tensor(pos)),
           JL.apply_rope(jcfg, jq, jnp.asarray(pos)), _tol(dtype, F32_LAYER))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_attention(params, dtype, impl):
    """Self-attention with the first layer's weights (QKV bias included),
    causal, with and without a window; ``pallas`` runs the Pallas kernel
    in interpret mode on one side and the port's plain version on the
    other."""
    jcfg, cfg = _cfgs(dtype)
    jb, tb = _first_block(*params)
    jx, tx = _x(3, (2, 24, 256), dtype)
    pos = np.tile(np.arange(24), (2, 1))
    for window in (None, 8):
        want = JL.attention(jcfg, jb["attn"], jx, jnp.asarray(pos),
                            window=window, impl=impl)
        got = L.attention(cfg, tb["attn"], tx, torch.as_tensor(pos),
                          window=window, impl=impl)
        _close(got, want, _tol(dtype, F32_LAYER))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(params, dtype):
    jcfg, cfg = _cfgs(dtype)
    jb, tb = _first_block(*params)
    jx, tx = _x(4, (2, 16, 256), dtype)
    _close(L.mlp(cfg, tb["mlp"], tx), JL.mlp(jcfg, jb["mlp"], jx),
           _tol(dtype, F32_LAYER))


def test_block_with_cache(params):
    jcfg, cfg = _cfgs("float32")
    jb, tb = _first_block(*params)
    jx, tx = _x(5, (2, 16, 256), "float32")
    pos = np.tile(np.arange(16), (2, 1))
    jy, _, jc = JB.apply_block(jcfg, jb, SIG, jx, jnp.asarray(pos),
                               collect_cache=True)
    ty, aux, tc = B.apply_block(cfg, tb, SIG, tx, torch.as_tensor(pos),
                                collect_cache=True)
    _close(ty, jy, F32_LAYER)
    assert float(aux) == 0.0
    for name in ("k", "v"):
        _close(tc[name], jc[name], F32_LAYER)


# -- the model ---------------------------------------------------------------
@pytest.mark.parametrize("head_mode", ["full", "last"])
def test_forward(params, head_mode):
    jcfg, cfg = _cfgs("float32")
    jp, tp = params
    jbatch, tbatch = _tokens(6, 2, 16)
    want, _, _ = jlm.forward(jcfg, jp, jbatch, head_mode=head_mode)
    got, aux, caches = lm.forward(cfg, tp, tbatch, head_mode=head_mode)
    assert got.shape == want.shape and caches is None
    _close(got, want, F32_MODEL)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_prefill_logits_and_cache(params, impl):
    jcfg, cfg = _cfgs("float32")
    jp, tp = params
    jbatch, tbatch = _tokens(7, 2, 16)
    jlast, jcache = jlm.prefill(jcfg, jp, jbatch, 24, impl=impl)
    tlast, tcache = lm.prefill(cfg, tp, tbatch, 24, impl=impl)
    _close(tlast, jlast, F32_MODEL)
    assert tcache["prefix"] == [] and set(tcache["scan"]) == {"pos_0"}
    for name in ("k", "v"):
        want = jcache["scan"]["pos_0"][name]
        got = tcache["scan"]["pos_0"][name]
        assert tuple(got.shape) == want.shape == (2, 2, 24, 2, 64)
        _close(got, want, F32_MODEL)
        assert not got[:, :, 16:].any()              # padded with zeros


@pytest.mark.parametrize("ring", [False, True])
def test_decode_steps(params, ring):
    """Greedy decode from a zeroed cache; the ring buffer of 8 slots wraps
    after 8 steps."""
    jcfg, cfg = _cfgs("float32")
    jp, tp = params
    steps_n, cl = (12, 8) if ring else (5, 16)
    jcache = jlm.init_cache(jcfg, 2, cl)
    tcache = lm.init_cache(cfg, 2, cl)
    jstep = jax.jit(jmake_serve_step(jcfg, ring=ring))
    tstep = steps.make_serve_step(cfg, ring=ring)
    jtok = jnp.asarray([3, 7], jnp.int32)
    ttok = torch.tensor([3, 7])
    for i in range(steps_n):
        jtok, jlogits, jcache = jstep(jp, jcache, jtok, jnp.int32(i))
        ttok, tlogits, tcache = tstep(tp, tcache, ttok, i)
        _close(tlogits, jlogits, F32_MODEL)
        assert ttok.tolist() == np.asarray(jtok).tolist()
    _close(tcache["scan"]["pos_0"]["k"], jcache["scan"]["pos_0"]["k"],
           F32_MODEL)


def test_decode_after_prefill_matches_forward(params):
    """As ``tests/test_models_smoke.py:49`` checks for the reference: the
    decode step at position S after a prefill of S tokens gives the
    logits ``forward`` gives at position S of the S + 1 tokens."""
    _, cfg = _cfgs("float32")
    _, tp = params
    _, tbatch = _tokens(8, 2, 17)
    toks = tbatch["tokens"]
    _, cache = lm.prefill(cfg, tp, {"tokens": toks[:, :16]}, 20)
    step, _ = lm.decode_step(cfg, tp, toks[:, 16], cache, 16)
    full, _, _ = lm.forward(cfg, tp, {"tokens": toks})
    torch.testing.assert_close(step, full[:, 16], atol=1e-5, rtol=1e-5)


def test_ref_and_pallas_differ_by_rounding():
    """The reference's attention rounds its logits through bf16, the flash
    kernel keeps them in float32: in bf16 the two prefills' last logits
    differ by a few percent of the logits' magnitude, growing slowly with
    depth (1.2% at 2 layers, 2.5% at 28 with these inputs). The card's
    check of the same gap at full width (``chip_smoke.py``,
    REF_VS_PALLAS_REL = 10%) is derived from this."""
    rel = {}
    for layers in (2, 28):
        cfg = get_config(ARCH).reduced(num_layers=layers)
        p = lm.compute_params(cfg, lm.init_params(
            cfg, torch.Generator().manual_seed(0)))
        toks = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 128)))}
        with torch.inference_mode():
            lp, _ = lm.prefill(cfg, p, toks, 128, impl="pallas")
            lr, _ = lm.prefill(cfg, p, toks, 128, impl="ref")
        rel[layers] = float((lp - lr).abs().max() / lr.abs().max())
    assert 0 < rel[2] < 0.05 and 0 < rel[28] < 0.05, rel


# -- serving -----------------------------------------------------------------
def _prompts(seed, n, V=512):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, V, rng.integers(4, 20))) for _ in range(n)]


def _reference_loop(jcfg, jp, prompts, max_new, bucket, impl):
    """The reference's prefill + greedy ``make_serve_step`` loop, as its
    ``serve_batch`` runs it, with the prefill's ``impl`` and every step's
    logits kept."""
    toks = serve.left_pad(prompts, bucket)
    K = toks.shape[1]
    last, cache = jax.jit(lambda p, b: jlm.prefill(
        jcfg, p, b, K + max_new, impl=impl))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    step = jax.jit(jmake_serve_step(jcfg))
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)
    out, logits = [tok], [last]
    for i in range(max_new - 1):
        tok, lg, cache = step(jp, cache, tok, jnp.int32(K + i))
        out.append(tok)
        logits.append(lg)
    return (np.stack([np.asarray(t) for t in out], axis=1),
            np.stack([np.asarray(x, np.float32) for x in logits], axis=1))


def _port_logits(cfg, tp, prompts, max_new, bucket, impl):
    toks = torch.as_tensor(serve.left_pad(prompts, bucket))
    K = toks.shape[1]
    w = lm.compute_params(cfg, tp)
    last, cache = steps.make_prefill_step(cfg, K + max_new, impl=impl)(
        w, {"tokens": toks})
    step = steps.make_serve_step(cfg)
    tok, logits = torch.argmax(last, dim=-1), [last]
    for i in range(max_new - 1):
        tok, lg, cache = step(w, cache, tok, K + i)
        logits.append(lg)
    return torch.stack(logits, dim=1).numpy()


def test_serve_batch_ref_matches_reference_serve_batch(params):
    jcfg, cfg = _cfgs("float32")
    jp, tp = params
    prompts = _prompts(0, 5)
    want = jserve.serve_batch(jcfg, jp, prompts, max_new=6, bucket=32)
    got = serve.serve_batch(cfg, tp, prompts, max_new=6, bucket=32,
                            impl="ref")
    assert got.dtype == np.int32 and got.shape == (5, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_batch_default_is_the_reference_attention(params,
                                                        monkeypatch):
    """Called as the reference's ``serve_batch`` is, with no ``impl``, the
    port prefills with the same plain attention (never the flash kernel's
    function) and returns the reference's tokens."""
    def no_flash(*args, **kwargs):
        raise AssertionError("the default prefill reached flash_attention")

    monkeypatch.setattr(ops, "flash_attention", no_flash)
    jcfg, cfg = _cfgs("float32")
    jp, tp = params
    prompts = _prompts(2, 5)
    want = jserve.serve_batch(jcfg, jp, prompts, max_new=4, bucket=32)
    got = serve.serve_batch(cfg, tp, prompts, max_new=4, bucket=32)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_main_defaults_to_the_reference_attention(capsys):
    serve.main(["--device", "cpu", "--requests", "1", "--max-new", "2",
                "--bucket", "8"])
    assert "attention ref" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_batch_pallas_matches_reference_loop(params, dtype):
    """float32: every step's logits within 1e-4 and the continuations equal
    token for token (the seed's smallest top-2 margin exceeds the
    tolerance, so equal tokens are what the logits imply); bf16: logits
    within the bf16 tolerance (ties within it may pick other tokens)."""
    jcfg, cfg = _cfgs(dtype)
    jp, tp = params
    prompts = _prompts(1, 4)
    jtok, jlogits = _reference_loop(jcfg, jp, prompts, 5, 32, "pallas")
    tlogits = _port_logits(cfg, tp, prompts, 5, 32, "pallas")
    np.testing.assert_allclose(tlogits, jlogits, atol=_tol(dtype),
                               rtol=_tol(dtype))
    if dtype == "float32":
        top2 = np.sort(jlogits, axis=-1)[..., -2:]
        assert float((top2[..., 1] - top2[..., 0]).min()) > F32_MODEL
        got = serve.serve_batch(cfg, tp, prompts, max_new=5, bucket=32,
                                impl="pallas")
        np.testing.assert_array_equal(got, jtok)


def test_serve_main_on_the_cpu():
    outs = serve.main(["--device", "cpu", "--requests", "2", "--max-new",
                       "3", "--bucket", "8"])
    assert outs.shape == (2, 3)


def test_serve_device_default_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--requests", "1"])


def test_serving_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        from repro_torch.launch import serve
        serve.main(["--device", "cpu", "--requests", "2", "--max-new", "2",
                    "--bucket", "8"])
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


# -- outside the slice -------------------------------------------------------
@pytest.mark.parametrize("override", [
    {"mla": True}, {"moe": True, "num_experts": 4, "experts_per_token": 2},
    {"ssm_type": "mamba", "attn_layer_period": 2},
    {"ssm_type": "xlstm", "slstm_period": 2, "slstm_offset": 1},
    {"is_encoder_decoder": True, "encoder_layers": 2},
    {"num_vision_patches": 16}])
def test_other_families_raise(override):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **override)
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*queue 3b"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))


def test_flash_impl_raises(params, monkeypatch):
    """``impl="flash"`` (the blockwise training attention) gives the plain
    attention's logits on the float32 model within 1e-5, over a 2 x 2 grid
    of tiles; an unknown implementation still raises."""
    _, cfg = _cfgs("float32")
    _, tbatch = _tokens(9, 2, 32)
    monkeypatch.setitem(L.FLASH_BLOCKS, "qblk", 16)
    monkeypatch.setitem(L.FLASH_BLOCKS, "kblk", 16)
    flash, _, _ = lm.forward(cfg, params[1], tbatch, impl="flash")
    ref, _, _ = lm.forward(cfg, params[1], tbatch, impl="ref")
    _close(flash, ref.numpy(), F32_LAYER)
    with pytest.raises(ValueError):
        lm.forward(cfg, params[1], tbatch, impl="splash")

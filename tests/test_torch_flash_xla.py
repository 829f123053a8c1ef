"""The port's ``flash_attention_xla`` (``models/layers.py``, the training
attention ``impl="flash"``) against the reference's, on the CPU: outputs,
and the gradients of ``sum(out * w)`` with respect to q, k and v (autograd
against ``jax.vjp``).

Shape: B 2, S 64, 4 query / 2 KV heads, hd 16, ``qblk = kblk = 16`` (a
4 x 4 grid of tiles the causal mask crosses), set through
``FLASH_BLOCKS`` on both sides. Cases: causal; a window of 24 (whole tiles
masked, wiped later by ``corr = 0``); ``tile_bf16``; S = 56, not a
multiple of the block (the ``_sdpa`` branch); bf16 inputs. Bounds: float32
within 1e-5 (absolute and relative; measured at most 1.9e-6 on values up
to 5.5); bf16 within 2e-2 absolute and relative, about two bf16 ulps
(measured: outputs 7.8e-3 apart on values up to 2.2, dq / dk / dv 1.6e-2
/ 3.1e-2 / 2.3e-2 on values up to 2.4 / 3.0 / 5.5, one ulp there; the two
frameworks add their bf16 products' float32 sums in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

B, HQ, HKV, HD, BLK = 2, 4, 2, 16, 16
F32, BF16 = 1e-5, 2e-2

CASES = {
    "causal": dict(S=64),
    "window24": dict(S=64, window=24),
    "tile_bf16": dict(S=64, tile_bf16=True),
    "indivisible": dict(S=56),
    "bf16": dict(S=64, dtype="bfloat16"),
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


def _inputs(S, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, HQ, HD), (B, S, HKV, HD), (B, S, HKV, HD),
              (B, S, HQ, HD)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _reference(q, k, v, w, S, window, dtype):
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    dt = jnp.dtype(dtype)
    f = lambda q, k, v: JL.flash_attention_xla(  # noqa: E731
        q, k, v, pos, pos, window=window)
    out, vjp = jax.vjp(f, *(jnp.asarray(a, dt) for a in (q, k, v)))
    grads = vjp(jnp.asarray(w, dt))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _port(q, k, v, w, S, window, dtype):
    dt = L.DTYPES[dtype]
    pos = torch.arange(S).expand(B, S)
    q, k, v = (torch.tensor(a).to(dt).requires_grad_(True) for a in (q, k, v))
    out = L.flash_attention_xla(q, k, v, pos, pos, window=window)
    (out.float() * torch.tensor(w).to(dt).float()).sum().backward()
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_xla_matches_the_reference(monkeypatch, case):
    c = CASES[case]
    S, window = c["S"], c.get("window")
    dtype = c.get("dtype", "float32")
    if c.get("tile_bf16"):
        monkeypatch.setitem(JL.FLASH_BLOCKS, "tile_bf16", True)
        monkeypatch.setitem(L.FLASH_BLOCKS, "tile_bf16", True)
    q, k, v, w = _inputs(S, dtype)
    want = _reference(q, k, v, w, S, window, dtype)
    got = _port(q, k, v, w, S, window, dtype)
    tol = F32 if dtype == "float32" else BF16
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


def test_flash_equals_sdpa_and_recomputes_its_tiles(monkeypatch):
    """The blockwise path gives the plain attention's values, and under
    autograd runs rematerialised: the backward runs the tiles again (two
    calls of the blockwise body for one forward and one backward)."""
    S = 64
    q, k, v, _ = _inputs(S, "float32", seed=1)
    q, k, v = (torch.tensor(a).requires_grad_(True) for a in (q, k, v))
    pos = torch.arange(S).expand(B, S)
    calls = []
    impl = L._flash_attention_xla_impl
    monkeypatch.setattr(L, "_flash_attention_xla_impl",
                        lambda *a, **kw: calls.append(1) or impl(*a, **kw))
    out = L.flash_attention_xla(q, k, v, pos, pos, window=40)
    assert len(calls) == 1
    out.sum().backward()
    assert len(calls) == 2
    mask = L._causal_mask(pos, pos, 40)
    np.testing.assert_allclose(
        out.detach().numpy(),
        L._sdpa(q, k, v, mask, 1 / np.sqrt(HD)).detach().numpy(),
        atol=F32, rtol=F32)
    with torch.no_grad():
        L.flash_attention_xla(q, k, v, pos, pos, window=40)
    assert len(calls) == 3

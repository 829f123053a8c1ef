"""The port's ``flash_attention`` on the CPU (its plain version) against the
JAX package: ``flash_attention_plain`` against the Pallas kernel
(``repro.kernels.ops.flash_attention``, interpret mode) and
``flash_attention_ref`` against the jnp oracle it twins. Inputs are made
with numpy from a seed and handed to both. The CUDA kernel runs only on
the card, where ``chip_smoke.py`` holds it against the plain version."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

# the reference's own tolerances (tests/test_kernels.py:28)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    ops.reset_launches()
    yield
    # a CPU tensor never reaches a kernel
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def _qkv(seed, B, S, Hq, Hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, hd)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]
    j = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    t = [torch.tensor(a).to(TORCH[dtype]) for a in arrs]
    return j, t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# each value of S in {128, 256}, (Hq, Hkv) in {(4, 4), (4, 2), (6, 1)},
# hd in {32, 64}, both dtypes and window None / 96 appears with each of the
# others; S = 1 and 100 are ragged lengths the Pallas kernel takes whole
SWEEP = [
    (128, 4, 4, 32, "float32", None), (128, 4, 2, 64, "bfloat16", 96),
    (128, 6, 1, 64, "float32", 96), (128, 4, 2, 32, "bfloat16", None),
    (256, 4, 4, 64, "bfloat16", 96), (256, 4, 2, 32, "float32", 96),
    (256, 6, 1, 32, "bfloat16", None), (256, 4, 2, 64, "float32", None),
    (256, 6, 1, 64, "float32", 96), (128, 4, 4, 64, "bfloat16", None),
    (1, 4, 2, 64, "float32", None), (100, 6, 1, 32, "bfloat16", 96),
]


@pytest.mark.parametrize("S,Hq,Hkv,hd,dtype,window", SWEEP)
def test_plain_matches_pallas(S, Hq, Hkv, hd, dtype, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(S * Hq + hd, 2, S, Hq, Hkv, hd, dtype)
    want = jops.flash_attention(jq, jk, jv, window=window)
    got = ref.flash_attention_plain(tq, tk, tv, window=window)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (2, S, Hq, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_ref_twins_the_jnp_oracle(dtype, window):
    """``flash_attention_ref`` with KV read per group against the oracle
    given repeated KV heads, both rounding their logits through the input
    dtype."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(7, 2, 24, 4, 2, 32, dtype)
    want = jref.flash_attention_ref(jq, jnp.repeat(jk, 2, 2),
                                    jnp.repeat(jv, 2, 2), window=window)
    got = ref.flash_attention_ref(tq, tk, tv, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_non_causal_matches_pallas():
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 1, 128, 4, 2, 32, "float32")
    want = jops.flash_attention(jq, jk, jv, causal=False)
    got = ref.flash_attention_plain(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_wrapper_is_the_plain_version(dtype):
    """The wrapper on CPU tensors returns the plain version bit for bit
    and counts no launch (the fixture checks the count)."""
    _, (tq, tk, tv) = _qkv(11, 2, 40, 6, 2, 64, dtype)
    got = ops.flash_attention(tq, tk, tv, window=17)
    want = ref.flash_attention_plain(tq, tk, tv, window=17)
    assert torch.equal(got, want)
    # a window of S or more is no window
    assert torch.equal(ops.flash_attention(tq, tk, tv, window=4096),
                       ops.flash_attention(tq, tk, tv))


def test_masked_tiles_change_nothing():
    """Keys outside every row's window carry no weight: perturbing them
    leaves the output as it was, the property that lets the kernel skip
    whole tiles."""
    _, (tq, tk, tv) = _qkv(5, 1, 200, 4, 2, 32, "float32")
    out = ref.flash_attention_plain(tq, tk, tv, window=8)
    k2, v2 = tk.clone(), tv.clone()
    k2[:, :150] = 1e3
    v2[:, :150] = -1e3
    out2 = ref.flash_attention_plain(tq, k2, v2, window=8)
    assert torch.equal(out[:, 157:], out2[:, 157:])


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 8, 4, 32))
    k = torch.zeros((1, 8, 2, 32))
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.to(torch.bfloat16), k)        # mixed dtype
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), k.half())      # fp16
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 8, 3, 32)),
                            torch.zeros((1, 8, 3, 32)))        # 4 % 3
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, torch.zeros((1, 7, 2, 32)))  # shapes
    with pytest.raises(ValueError):
        ops.flash_attention(q[0], k[0], k[0])                  # not 4-D
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, window=0)


def test_kernel_is_built_from_its_source():
    assert "flash_attention" in build.SOURCES
    source, argtypes = build.SIGNATURES["flash_attention_launch"]
    assert source == "flash_attention"
    text = (build.CSRC / "flash_attention.cu").read_text()
    assert "flash_attention.py::flash_attention_pallas" in text
    assert all(f"case {hd}:" in text for hd in ops.FLASH_HEAD_DIMS)


# -- the bf16 tensor-core kernel's arithmetic, emulated on the CPU ---------
def _bf16_ulps_apart(a, b, atol=0.0):
    """Largest distance of bf16 ``a`` from ``b``, less ``atol``, in bf16
    ulps at the larger magnitude of each pair (chip_smoke.py's measure)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)         # 8 significant bits
    return float(((a - b).abs() - atol).clamp(min=0.0).div(ulp).max())


def _tensor_core_emulation(q, k, v, *, causal=True, window=None, bk=64,
                           split=True):
    """What the bf16 CUDA kernel does, step by step in eager PyTorch: BK-key
    tiles in order with the online softmax in float32; q.k of the bf16
    inputs summed in float32 (each bf16 x bf16 product is exact there);
    p split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), both products
    with V summed in float32; l summed from the unrounded p. ``split=False``
    rounds p to bf16 once instead."""
    B, S, Hq, hd = q.shape
    G = Hq // k.shape[2]
    qf = q.float().transpose(1, 2)                        # (B, Hq, S, hd)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    m = torch.full((B, Hq, S), -1e30)
    l = torch.zeros((B, Hq, S))
    o = torch.zeros((B, Hq, S, hd))
    qp = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = (qf @ kt.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        if causal:
            kp = torch.arange(k0, k0 + kt.shape[2])[None, :]
            ok = kp <= qp
            if window is not None:
                ok = ok & (kp > qp - window)
            s = torch.where(ok, s, torch.full((), -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        o = o * corr[..., None] + hi @ vt
        if split:
            o = o + (p - hi).to(torch.bfloat16).float() @ vt
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


# ragged S (1, 127, 130, 1000), windows, hd 64 and 128, G = 1 and 6, and a
# non-causal call
EMULATED = [  # (B, S, Hq, Hkv, hd, window, causal)
    (2, 1, 12, 2, 128, None, True), (1, 127, 12, 2, 128, None, True),
    (1, 200, 6, 1, 64, None, True), (1, 300, 4, 4, 128, 96, True),
    (1, 130, 4, 2, 64, 40, True), (1, 1000, 2, 1, 128, None, True),
    (1, 100, 4, 2, 128, None, False),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window,causal", EMULATED)
def test_tensor_core_arithmetic_is_within_one_bf16_ulp(B, S, Hq, Hkv, hd,
                                                       window, causal):
    """The bound chip_smoke.py holds the kernel to: at most one bf16 ulp
    beyond atol 2e-5 of the plain version. Both compute in float32 and
    round once to bf16, so a sum taken in another order can land on the
    neighbouring bf16 value; an output near zero (a sum that cancels)
    carries a float32 rounding error of ~1e-7, which the atol covers."""
    _, (tq, tk, tv) = _qkv(S + hd + Hq, B, S, Hq, Hkv, hd, "bfloat16")
    got = _tensor_core_emulation(tq, tk, tv, causal=causal, window=window)
    want = ref.flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _bf16_ulps_apart(got, want, atol=2e-5) <= 1.0


def test_one_bf16_rounding_of_p_breaks_the_bound():
    """Why the kernel splits p: rounded once to bf16 (what the reference's
    jnp oracle does), p errs by up to 2^-9 of each weight, and an output
    that cancels near zero then lands hundreds of bf16 ulps (beyond atol
    2e-5) from the plain version."""
    _, (tq, tk, tv) = _qkv(1, 1, 127, 12, 2, 128, "bfloat16")
    got = _tensor_core_emulation(tq, tk, tv, split=False)
    want = ref.flash_attention_plain(tq, tk, tv)
    assert _bf16_ulps_apart(got, want, atol=2e-5) > 1.0

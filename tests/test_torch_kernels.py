"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package: ``masked_pseudo_ce`` and ``staleness_agg`` against the
Pallas kernels in interpret mode, ``csr_compact`` / the capped mask
against the jnp oracles (the Pallas compaction does not run on this jax).
The CUDA kernels themselves run only on the card, in ``chip_smoke.py``."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    ops.reset_launches()
    yield
    # a CPU tensor never reaches a kernel
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


@pytest.mark.parametrize("N,C", [(100, 9), (300, 9), (77, 17), (64, 40)])
@pytest.mark.parametrize("theta", [0.5, 0.95])
def test_masked_pseudo_ce_matches_pallas(N, C, theta):
    """Forward and gradient at atol 1e-6: the log-space loss is
    ``m - lse`` with m the row max, so its rounding is ~1 ulp of m (logits
    here stay below 16, ulp <= 9.5e-7)."""
    rng = np.random.default_rng(N * C)
    x = (rng.standard_normal((N, C)) * 3).astype(np.float32)
    g = rng.random(N).astype(np.float32)
    jl, jm = jops.masked_pseudo_ce(jnp.asarray(x), theta)
    jg = jax.grad(lambda lg: jnp.sum(
        jops.masked_pseudo_ce(lg, theta)[0] * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tl, tm = ops.masked_pseudo_ce(xt, theta)
    (tg,) = torch.autograd.grad((tl * torch.from_numpy(g)).sum(), xt)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)


def test_masked_pseudo_ce_rows_at_threshold_use_log_space():
    """Rows whose max softmax sweeps across theta finer than one ulp of
    max_logp: the port's mask is the TPU kernel's ``max_logp >= log theta``
    row for row, while the jnp oracle's ``exp(max_logp) >= theta`` differs
    on some of them (so the sweep tells the two rules apart)."""
    theta = 0.95
    # logits (0, b x 7, c): max softmax = 1 / (1 + 7 e^b + e^c); 7 e^b
    # carries 99% of the mass that puts it at theta, and stepping c by one
    # ulp moves max_logp by ~1/10 of one of its own ulps
    mass = 1 / theta - 1
    c_star = np.float32(np.log(0.01 * mass))
    c = c_star + np.arange(-4096, 4096, dtype=np.float32) * \
        np.spacing(c_star)
    x = np.zeros((c.size, 9), np.float32)
    x[:, 1:8] = np.float32(np.log(0.99 * mass / 7))
    x[:, 8] = c
    jl, jm = jops.masked_pseudo_ce(jnp.asarray(x), theta)
    _, em = jref.masked_pseudo_ce_ref(jnp.asarray(x), theta)
    tl, tm = ref.masked_pseudo_ce_ref(torch.from_numpy(x), theta)
    assert 0 < tm.sum() < c.size            # the sweep crosses theta
    assert (np.asarray(em) != np.asarray(jm)).any()
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6, rtol=0)


@pytest.mark.parametrize("K,n", [(3, 512), (6, 1000), (2, 70001), (1, 17)])
def test_staleness_agg_matches_pallas(K, n):
    """rtol 1e-6, plus atol 1e-6 (4 ulp of the O(1) summands) for entries
    that cancel: the two sum K products in different roundings."""
    rng = np.random.default_rng(K * n)
    d = rng.standard_normal((K, n)).astype(np.float32)
    w = rng.random(K).astype(np.float32)
    out = ops.staleness_agg(torch.from_numpy(d), torch.from_numpy(w))
    want = jops.staleness_agg(jnp.asarray(d), jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _delta(rng, K, n, zero_frac=0.1):
    x = rng.standard_normal((K, n)).astype(np.float32) * 1e-3
    x[rng.random((K, n)) < zero_frac] = 0.0
    return x


@pytest.mark.parametrize("case", ["ragged", "overflow", "thr_le_0",
                                  "all_zero_row", "multi_row"])
def test_csr_compact_and_capped_mask_match_jnp_oracles(case):
    rng = np.random.default_rng(len(case))
    K, n = {"multi_row": (4, 3000), "all_zero_row": (2, 700)}.get(
        case, (1, 5213))                     # 5213 % 512 = 93: ragged tail
    x = _delta(rng, K, n)
    thr = np.quantile(np.abs(x), 0.8, axis=1).astype(np.float32)
    cap = max(int(np.ceil(0.5 * n)), 1)
    if case == "overflow":
        cap = max(int((np.abs(x) >= thr[:, None]).sum()) // 3, 1)
    elif case == "thr_le_0":
        thr = np.array([0.0] * (K - 1) + [-1.0], np.float32)
    elif case == "all_zero_row":
        x[0] = 0.0
    jv, ji, jn = jref.csr_compact2d_ref(jnp.asarray(x), jnp.asarray(thr), cap)
    tv, ti, tn = ops.csr_compact(torch.from_numpy(x), torch.from_numpy(thr),
                                 cap)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.dtype == torch.int32 and ti.dtype == torch.int32
    jd, js = jref.csr_capped_mask_ref(jnp.asarray(x), jnp.asarray(thr), cap)
    td, ts = ref.csr_capped_mask_ref(torch.from_numpy(x),
                                     torch.from_numpy(thr), cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the capped mask is the payload's scatter decode
    np.testing.assert_array_equal(ref.csr_decode_ref(tv, ti, n).numpy(),
                                  td.numpy())
    # and so is the comm layer's decode of the stored slots, bit for bit
    from repro_torch.core.sparse_comm import csr_decode
    decoded = csr_decode(tv, ti, torch.clamp(tn, max=cap), n)
    assert decoded.shape == (K, n)
    np.testing.assert_array_equal(decoded.numpy(), td.numpy())


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((2, 10))
    with pytest.raises(TypeError):
        ops.csr_compact(x.double(), torch.zeros(2), 5)
    with pytest.raises(ValueError):
        ops.csr_compact(x, torch.zeros(3), 5)
    with pytest.raises(ValueError):
        ops.csr_compact(x, torch.zeros(2), 11)
    with pytest.raises(ValueError):
        ops.staleness_agg(x.t(), torch.zeros(10))      # not contiguous
    with pytest.raises(ValueError):
        ops.masked_pseudo_ce(torch.zeros(9), 0.95)     # not 2-D


def test_every_launch_function_is_exported_by_its_source():
    """The ctypes signatures name C functions their sources define; nvcc is
    not available here, so the build itself is checked on the card."""
    for fn, (source, argtypes) in build.SIGNATURES.items():
        text = (build.CSRC / f"{source}.cu").read_text()
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m, (fn, source)
        assert len(m.group(1).split(",")) == len(argtypes), fn
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == \
        sorted(build.SOURCES)
    assert Path(build.build_dir()).parent == build.BUILD_ROOT


def test_build_dir_covers_the_shared_headers(tmp_path, monkeypatch):
    """A change to a header the sources include (``csrc/*.cuh``) builds
    every kernel anew, as a change to a source does."""
    headers = sorted(build.CSRC.glob("*.cuh"))
    assert [h.name for h in headers] == ["mbarrier.cuh"]
    for name in ("flash_attention", "masked_pseudo_ce"):
        assert '#include "mbarrier.cuh"' in \
            (build.CSRC / f"{name}.cu").read_text()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.glob("*.cu*"):
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.build_dir()
    (csrc / "mbarrier.cuh").write_text(headers[0].read_text() + "\n")
    assert build.build_dir() != before

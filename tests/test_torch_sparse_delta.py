"""The ``sparse_delta`` kernel's plain version and the ``dense_masked`` /
disabled comm paths of the port on the CPU, against the JAX package: the
plain version against the Pallas ``sparse_delta2d_pallas`` in interpret
mode (bit for bit), thresholds against the reference's two quantile
routes (bit for bit), and encodes, byte ledgers and the base store's
broadcast booking against ``SparseComm(use_kernel=False)`` (exactly).
The CUDA kernel itself runs only on the card, in ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import base_store as jbs  # noqa: E402
from repro.core import sparse_comm as jsc  # noqa: E402
from repro.kernels.sparse_delta import (  # noqa: E402
    local_quantile_thresholds, sparse_delta2d_pallas,
    sparse_delta2d_quantile_pallas, sparse_delta_pallas)
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import base_store as tbs  # noqa: E402
from repro_torch.core import sparse_comm as tsc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

SMALL = dict(conv_filters=(8, 8), hidden=16)


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    ops.reset_launches()
    yield
    # a CPU tensor never reaches a kernel
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def _delta(rng, K, n, zero_frac=0.1):
    x = rng.standard_normal((K, n)).astype(np.float32) * 1e-3
    x[rng.random((K, n)) < zero_frac] = 0.0
    return x


@pytest.mark.parametrize("case", ["ragged", "thr_le_0", "exact_zeros",
                                  "aligned", "one_row", "tiny"])
def test_sparse_delta_matches_pallas(case):
    """The plain version equals the Pallas kernel in interpret mode bit for
    bit: masked values (signed zeros included) and per-block counts. The
    pad columns of a ragged tail never count, even when ``thr <= 0``."""
    rng = np.random.default_rng(len(case))
    K, n = {"aligned": (2, 2048), "one_row": (1, 5213),
            "tiny": (3, 7)}.get(case, (3, 5213))     # 5213 % 512 = 93
    x = _delta(rng, K, n)
    thr = np.quantile(np.abs(x), 0.8, axis=1).astype(np.float32)
    if case == "thr_le_0":
        thr = np.array([0.0, -1.0, 1e-4], np.float32)
    elif case == "exact_zeros":
        x[0] = 0.0
        x[1, ::2] = -0.0
        thr[:2] = 0.0
    jm, jn = sparse_delta2d_pallas(jnp.asarray(x), jnp.asarray(thr),
                                   interpret=True)
    tm, tn = ops.sparse_delta_batch(torch.from_numpy(x),
                                    torch.from_numpy(thr))
    assert tm.dtype == torch.float32 and tn.dtype == torch.int32
    assert tuple(tn.shape) == (K, -(-n // 512))
    np.testing.assert_array_equal(tm.numpy().view(np.int32),
                                  np.asarray(jm).view(np.int32))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(
        tn.numpy().sum(1), (np.abs(x) >= thr[:, None]).sum(1))
    if case == "thr_le_0":
        assert tn[0].sum() == n                 # every column, no pad
    # the K = 1 form against its Pallas twin
    jm1, jn1 = sparse_delta_pallas(jnp.asarray(x[0]), float(thr[0]),
                                   interpret=True)
    tm1, tn1 = ops.sparse_delta(torch.from_numpy(x[0]), float(thr[0]))
    np.testing.assert_array_equal(tm1.numpy(), np.asarray(jm1))
    np.testing.assert_array_equal(tn1.numpy(), np.asarray(jn1))
    rm, rn = ref.sparse_delta_ref(torch.from_numpy(x[0]), float(thr[0]))
    assert torch.equal(rm, tm1) and torch.equal(rn, tn1)


@pytest.mark.parametrize("K,n", [(1, 10385), (3, 5000), (2, 70001)])
def test_topfrac_matches_pallas_and_thresholds_are_bit_equal(K, n):
    """Both of the reference's threshold routes equal the port's bit for
    bit: the batched core's ``local_quantile_thresholds`` (and its vmapped
    ``_sampled_quantile_batch``) the port's default, the sequential
    encode's 1-D ``_sampled_quantile``, which fuses the other product of
    the interpolation, the port's ``fused="high"``. At (3, 5000) the two
    reference routes differ from each other in the last bit of a row."""
    x = _delta(np.random.default_rng(n), K, n)
    jm, jn, jthr = sparse_delta2d_quantile_pallas(jnp.asarray(x), 0.2,
                                                  interpret=True)
    tm, tn, tthr = ops.sparse_delta_topfrac(torch.from_numpy(x), 0.2)
    np.testing.assert_array_equal(tthr.numpy(), np.asarray(jthr))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(
        tthr.numpy(), np.asarray(jax.jit(local_quantile_thresholds,
                                         static_argnums=1)(jnp.asarray(x),
                                                           0.2)))
    seq = np.asarray([jsc._sampled_quantile(jnp.asarray(row), 1.0 - 0.2)
                      for row in x], np.float32)
    np.testing.assert_array_equal(
        ref.local_quantile_thresholds(torch.from_numpy(x), 0.2,
                                      fused="high").numpy(), seq)
    if (K, n) == (3, 5000):
        assert not np.array_equal(tthr.numpy(), seq)
    np.testing.assert_array_equal(
        tthr.numpy(), np.asarray(jsc._sampled_quantile_batch(
            jnp.asarray(x), 1.0 - 0.2)))


def test_sparse_delta_wrappers_reject_bad_inputs():
    x = torch.zeros((2, 10))
    with pytest.raises(TypeError):
        ops.sparse_delta_batch(x.double(), torch.zeros(2))
    with pytest.raises(ValueError):
        ops.sparse_delta_batch(x, torch.zeros(3))
    with pytest.raises(ValueError):
        ops.sparse_delta_batch(x.t(), torch.zeros(10))   # not contiguous
    with pytest.raises(ValueError):
        ops.sparse_delta(x, 0.1)                         # not 1-D
    with pytest.raises(TypeError):
        ops.sparse_delta_batch(x, torch.zeros(2, dtype=torch.float64))


def _tree(seed):
    p = jcnn.init_cnn(JCNN(**SMALL), jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in p.items()}


def _pair(seed):
    """(new, base) trees whose delta has exact zeros (untouched biases)."""
    base = _tree(seed)
    rng = np.random.default_rng(seed)
    new = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 1e-3
               * (rng.random(v.shape) < 0.9)).astype(np.float32)
           for k, v in base.items()}
    return new, base


@pytest.mark.parametrize("wire,enabled,threshold", [
    ("dense_masked", True, "p0.2"), ("dense_masked", True, 5e-4),
    ("dense_masked", True, -1.0), ("dense_masked", False, "p0.2"),
    ("csr", False, "p0.2")])
def test_dense_wire_encode_matches(wire, enabled, threshold):
    """``encode`` (one message) and ``encode_batch`` (a stack) on the
    dense_masked wire and the disabled channel: the receiver's deltas, the
    counts and the byte ledger equal the reference's exactly."""
    kw = dict(enabled=enabled, wire_format=wire)
    jc = jsc.SparseComm(threshold, use_kernel=False, **kw)
    tc = tsc.SparseComm(threshold, **kw)
    news, bases = [], []
    for seed in (0, 1, 2):
        new, base = _pair(seed)
        jd, js = jc.encode(new, base)
        td, ts = tc.encode(params_from_numpy(new, "cpu"),
                           params_from_numpy(base, "cpu"))
        assert int(ts["nnz"]) == int(js["nnz"]) and ts["total"] == js["total"]
        for k in jd:
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
        up_j, up_t = jc.apply(base, jd), tc.apply(
            params_from_numpy(base, "cpu"), td)
        for k in up_j:
            np.testing.assert_array_equal(up_t[k].numpy(),
                                          np.asarray(up_j[k]))
        news.append(np.asarray(jsc.flatten_tree(new)))
        bases.append(np.asarray(jsc.flatten_tree(base)))
    new, base = np.stack(news), np.stack(bases)
    jm, js = jc.encode_batch(jnp.asarray(new), jnp.asarray(base))
    tm, ts = tc.encode_batch(torch.from_numpy(new), torch.from_numpy(base))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts["nnz"].numpy(), np.asarray(js["nnz"]))
    if enabled and wire == "dense_masked":
        # the engines' fused core: the same mask and counts, nothing booked
        before = tc.messages
        cm, cn = tc.batch_core(torch.from_numpy(new), torch.from_numpy(base))
        jcm, jcn = jc.batch_core(False)(jnp.asarray(new), jnp.asarray(base))
        np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
        np.testing.assert_array_equal(cn.numpy(), np.asarray(jcn))
        assert tc.messages == before
    assert tc.wire_breakdown() == jc.wire_breakdown()
    assert tc.aco == jc.aco and tc.messages == jc.messages
    assert tc.dense_bytes == jc.dense_bytes


@pytest.mark.parametrize("enabled", [True, False])
def test_store_broadcast_booking_on_dense_wires(enabled):
    """Four transitions through both stores on the dense_masked wire (and
    the disabled channel, where the broadcast is one dense payload), with
    targets at different versions: ring rows, versions, store bytes and
    both ledgers agree exactly."""
    g0 = jsc.flatten_tree(_tree(0))
    n, M, tau = int(g0.shape[0]), 6, 2
    js, ts = jbs.VersionedBaseStore(g0, M, tau), \
        tbs.VersionedBaseStore(torch.tensor(np.asarray(g0)), M, tau)
    kw = dict(enabled=enabled, wire_format="dense_masked")
    jc = jsc.SparseComm("p0.2", use_kernel=False, **kw)
    tc = tsc.SparseComm("p0.2", **kw)
    jcore = jc.batch_core(False)
    rng = np.random.default_rng(0)
    for v, targets in enumerate(([0, 1, 2], [3, 4], [0, 5], [1, 2, 3]), 1):
        prev = np.asarray(js.latest())
        new = (prev + rng.standard_normal(n).astype(np.float32) * 1e-3
               ).astype(np.float32)
        if enabled:
            jm, jn = jcore(jnp.asarray(new)[None], jnp.asarray(prev)[None])
            js.advance(jnp.asarray(prev) + jm[0], {"stored": jn[0]}, v)
            tm, tn = tc.batch_core(torch.from_numpy(new)[None],
                                   ts.latest()[None])
            ts.advance(ts.latest() + tm[0], {"stored": tn[0]}, v)
        else:
            js.advance(jnp.asarray(new), {"stored": n}, v)
            ts.advance(torch.from_numpy(new), {"stored": n}, v)
        js.account_distribution(jc, targets)
        ts.account_distribution(tc, targets)
        np.testing.assert_array_equal(ts.ring.numpy(), np.asarray(js.ring))
        np.testing.assert_array_equal(ts.client_version, js.client_version)
        # the same ring, chain, versions and detach flags
        assert ts.bytes() == js.bytes()
    assert ts.dist_payload_bytes() == js.dist_payload_bytes()
    assert tc.wire_breakdown() == jc.wire_breakdown()
    assert tc.aco == jc.aco and tc.messages == jc.messages


def test_flatten_stacked_round_trip():
    trees = [_tree(s) for s in (3, 4)]
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    jf = jsc.flatten_stacked(stacked)
    tf = tsc.flatten_stacked(params_from_numpy(stacked, "cpu"))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    template = {k: torch.empty(v.shape, device="meta")
                for k, v in trees[0].items()}
    back = tsc.unflatten_stacked(tf, template)
    jback = jsc.unflatten_stacked(jf, trees[0])
    for k in stacked:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
        np.testing.assert_array_equal(back[k].numpy(), stacked[k])

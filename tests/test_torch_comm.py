"""The port's CSR comm layer, aggregation and versioned base store against
the JAX package on the CPU (reference runs use the jnp oracles,
``use_kernel=False``, as the Pallas compaction does not run on this
jax). Thresholds, payloads, stored counts, decodes and byte ledgers are
held exactly; aggregated weights at float32 rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import base_store as jbs  # noqa: E402
from repro.core import functions as jfun  # noqa: E402
from repro.core import sparse_comm as jsc  # noqa: E402
from repro.kernels.sparse_delta import local_quantile_thresholds  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import base_store as tbs  # noqa: E402
from repro_torch.core import sparse_comm as tsc  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402,E501

SMALL = dict(conv_filters=(8, 8), hidden=16)


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


def test_flatten_order_is_the_reference_leaf_order():
    t = _tree(0)
    np.testing.assert_array_equal(
        tsc.flatten_tree(params_from_numpy(t, "cpu")).numpy(),
        np.asarray(jsc.flatten_tree(t)))
    flat = tsc.flatten_tree(params_from_numpy(t, "cpu"))
    back = tsc.unflatten_like(flat, params_from_numpy(t, "cpu"))
    for k in t:
        np.testing.assert_array_equal(back[k].numpy(), t[k])


@pytest.mark.parametrize("K,n", [(1, 10385), (3, 5000), (2, 70001)])
def test_quantile_thresholds_equal(K, n):
    x = np.random.default_rng(n).standard_normal((K, n)).astype(np.float32)
    np.testing.assert_array_equal(
        tsc.local_quantile_thresholds(torch.from_numpy(x), 0.2).numpy(),
        np.asarray(jax.jit(local_quantile_thresholds, static_argnums=1)(
            jnp.asarray(x), 0.2)))


@pytest.mark.parametrize("n", [10385, 5_213_449, 7, 1])
def test_payload_capacity_equal(n):
    for thr, cap in (("p0.2", None), ("p0.05", None), (1e-3, None),
                     ("p0.2", 100)):
        a = jsc.SparseComm(thr, use_kernel=False, capacity=cap)
        b = tsc.SparseComm(thr, capacity=cap)
        assert a.payload_capacity(n) == b.payload_capacity(n)
    if n == 5_213_449:
        assert tsc.SparseComm().payload_capacity(n) == 2_606_725


@pytest.mark.parametrize("threshold,capacity", [
    ("p0.2", None), ("p0.2", 300), (5e-4, None)])
def test_encode_matches(threshold, capacity):
    jc = jsc.SparseComm(threshold, use_kernel=False, capacity=capacity)
    tc = tsc.SparseComm(threshold, capacity=capacity)
    for seed in (0, 1, 2):
        new, base = _pair(seed)
        jd, js = jc.encode(new, base)
        td, ts = tc.encode(params_from_numpy(new, "cpu"),
                           params_from_numpy(base, "cpu"))
        assert int(ts["nnz"]) == int(js["nnz"]) and ts["total"] == js["total"]
        # the payload the decode scatters from (encode books, csr_core not)
        flat = tsc.flatten_tree(tsc.tree_sub(params_from_numpy(new, "cpu"),
                                             params_from_numpy(base, "cpu")))
        (tv, ti), tst, _ = tc.csr_core(flat[None],
                                       torch.zeros_like(flat)[None])
        assert int(tst[0]) == int(js["nnz"])
        np.testing.assert_array_equal(tv[0].numpy(), np.asarray(js["values"]))
        np.testing.assert_array_equal(ti[0].numpy(), np.asarray(js["indices"]))
        for k in jd:
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
        up_j = jc.apply(base, jd)
        up_t = tc.apply(params_from_numpy(base, "cpu"), td)
        for k in up_j:
            np.testing.assert_array_equal(up_t[k].numpy(),
                                          np.asarray(up_j[k]))
    assert tc.wire_breakdown() == jc.wire_breakdown()
    assert tc.aco == jc.aco and tc.messages == jc.messages
    if capacity == 300:              # the capacity bound really cut rows
        assert int(ts["nnz"]) == 300


def test_combine_weights_equal():
    g = jfun.staleness_fn("exponential")
    sizes, stale = [30, 0, 12, 50, 7], [0, 1, 2, 0, 1]
    for groups in (None, [0, 1, 0, 2, 1], [1, 1, 1, 1, 1]):
        np.testing.assert_array_equal(
            tagg.combine_weights(sizes, stale, g, groups),
            jagg.combine_weights(sizes, stale, g, groups))


@pytest.mark.parametrize("groups", [None, [0, 2, 1, 0, 2, 1]])
def test_aggregate_matches(groups):
    g = jfun.staleness_fn("exponential")
    server = _tree(10)
    clients = [_tree(20 + i) for i in range(6)]
    kw = dict(data_sizes=[30, 11, 52, 7, 19, 40],
              stalenesses=[0, 1, 0, 2, 1, 0], g_fn=g, f_weight=0.4,
              groups=None if groups is None else np.asarray(groups))
    want = jagg.aggregate(server, clients, use_kernel=False, **kw)
    got = tagg.aggregate(params_from_numpy(server, "cpu"),
                         [params_from_numpy(c, "cpu") for c in clients], **kw)
    got = params_to_numpy(got)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_versioned_store_advance_and_accounting():
    """Four transitions through both stores (chain payloads from each
    package's own CSR core), with targets at different versions so the
    broadcast suffix varies; ring rows, versions, bytes and ledgers must
    agree exactly."""
    g0 = jsc.flatten_tree(_tree(0))
    n, M, tau = int(g0.shape[0]), 6, 2
    js, ts = jbs.VersionedBaseStore(g0, M, tau), \
        tbs.VersionedBaseStore(torch.tensor(np.asarray(g0)), M, tau)
    jc, tc = jsc.SparseComm("p0.2", use_kernel=False), tsc.SparseComm("p0.2")
    jcore = jc.csr_core(False)
    rng = np.random.default_rng(0)
    for v, targets in enumerate(([0, 1, 2], [3, 4], [0, 5], [1, 2, 3]), 1):
        prev = np.asarray(js.latest())
        new = (prev + rng.standard_normal(n).astype(np.float32) * 1e-3
               ).astype(np.float32)
        (jv, ji), jst, jdec = jcore(jnp.asarray(new)[None],
                                    jnp.asarray(prev)[None])
        (tv, ti), tst, tdec = tc.csr_core(torch.from_numpy(new)[None],
                                          ts.latest()[None])
        js.advance(jnp.asarray(prev) + jdec[0],
                   {"vals": jv[0], "idx": ji[0], "stored": jst[0]}, v)
        ts.advance(ts.latest() + tdec[0],
                   {"vals": tv[0], "idx": ti[0], "stored": tst[0]}, v)
        js.account_distribution(jc, targets)
        ts.account_distribution(tc, targets)
        np.testing.assert_array_equal(ts.ring.numpy(), np.asarray(js.ring))
        np.testing.assert_array_equal(ts.client_version, js.client_version)
        np.testing.assert_array_equal(ts.gather([0, 3, 5]).numpy(),
                                      np.asarray(js.gather([0, 3, 5])))
        # the same ring, chain, versions and detach flags
        assert ts.bytes() == js.bytes()
    assert ts.dist_payload_bytes() == js.dist_payload_bytes()
    assert tc.wire_breakdown() == jc.wire_breakdown()
    assert tc.aco == jc.aco
    with pytest.raises(ValueError):
        ts.account_distribution(tc, [1])       # already at the new version

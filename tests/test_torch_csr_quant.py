"""The ``csr_quant`` kernel's plain version and the csr_q wire of the port on
the CPU, against the JAX package: the plain version against the Pallas
``csr_quantize2d_pallas`` in interpret mode (bit for bit: q, offsets, block
counts, scales), the index pack / unpack and the dequantizing decodes
against the reference's oracles, and the csr_q aggregation, byte ledger and
base-store booking against ``SparseComm(use_kernel=False)``. The CUDA
kernel itself runs only on the card, in ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import base_store as jbs  # noqa: E402
from repro.core import sparse_comm as jsc  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.csr_quant import csr_quantize2d_pallas  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import base_store as tbs  # noqa: E402
from repro_torch.core import sparse_comm as tsc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    ops.reset_launches()
    yield
    # a CPU tensor never reaches a kernel
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def _payload(rng, K, n, keep=0.2, cap=None):
    """Real CSR payload rows: (values, indices, stored) from the plain
    csr_compact of update-sized deltas, a tenth exact zeros."""
    x = rng.standard_normal((K, n)).astype(np.float32) * 1e-3
    x[rng.random((K, n)) < 0.1] = 0.0
    x = torch.from_numpy(x)
    cap = cap or max(1, int(np.ceil(2.5 * keep * n)))
    v, i, nnz = ref.csr_compact2d_ref(
        x, ref.local_quantile_thresholds(x, keep), cap)
    return v, i, torch.clamp(nnz, max=cap)


def _pallas(v, i, s, n, q_dtype):
    return [np.asarray(a) for a in csr_quantize2d_pallas(
        jnp.asarray(v.numpy()), jnp.asarray(i.numpy()),
        jnp.asarray(s.numpy()), n, q_dtype=q_dtype)]


def _same_bits(got, want):
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        got, want = got.view(f"i{got.itemsize}"), want.view(f"i{got.itemsize}")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q_dtype", ["int8", "fp16"])
@pytest.mark.parametrize("case", ["ragged", "stored_0_and_full", "cap_cut"])
def test_plain_version_matches_pallas(case, q_dtype):
    """The plain quadruple equals the Pallas kernel's in interpret mode bit
    for bit, on a ragged width (5213 = 10 * 512 + 93), with one row storing
    nothing and one filling its capacity exactly, and with a capacity
    below the survivor count."""
    rng = np.random.default_rng(len(case))
    n = 5213
    if case == "cap_cut":
        v, i, s = _payload(rng, 2, n, cap=300)
        assert int(s.min()) == 300
    else:
        v, i, s = _payload(rng, 3, n)
    if case == "stored_0_and_full":
        cap = int(s[2])          # row 2 exactly full, its columns ascending
        v, i = v[:, :cap].contiguous(), i[:, :cap].contiguous()
        s = torch.clamp(s, max=cap)
        s[0] = 0
    got = ops.csr_quantize(v, i, s, n, q_dtype=q_dtype)
    for g, w in zip(got, _pallas(v, i, s, n, q_dtype)):
        _same_bits(g.numpy(), w)
    assert got[0].dtype == {"int8": torch.int8, "fp16": torch.float16}[q_dtype]
    np.testing.assert_array_equal(got[2].sum(dim=1).numpy(),
                                  s.clamp(max=v.shape[1]).numpy())


def test_scale_is_absmax_times_the_float_reciprocal_of_127():
    """The reference writes ``absmax / 127``; its compiler rewrites that as
    ``absmax * fl(1/127)``, which differs by an ulp on some rows. The plain
    version follows the compiled reference (the Pallas kernel's and the
    jitted oracle's scales), not the written division, which the oracle
    gives only when run op by op."""
    rng = np.random.default_rng(11)
    K, cap = 400, 16
    v = (rng.standard_normal((K, cap)) *
         10.0 ** rng.uniform(-6, 2, (K, 1))).astype(np.float32)
    i = np.tile(np.arange(cap, dtype=np.int32) * 3, (K, 1))
    s = np.full(K, cap, np.int32)
    _, _, _, scales = ops.csr_quantize(torch.from_numpy(v),
                                       torch.from_numpy(i),
                                       torch.from_numpy(s), 3 * cap)
    absmax = np.abs(v).max(axis=1)
    want = absmax * np.float32(1.0 / 127.0)
    _same_bits(scales.numpy(), want)
    assert (want != absmax / np.float32(127.0)).any()
    _same_bits(scales.numpy(), _pallas(torch.from_numpy(v),
                                       torch.from_numpy(i),
                                       torch.from_numpy(s), 3 * cap,
                                       "int8")[3])
    jitted = jax.jit(jref.csr_quantize2d_ref)(jnp.asarray(v),
                                              jnp.asarray(s))[1]
    _same_bits(scales.numpy(), np.asarray(jitted))
    # the oracle run op by op divides as written
    eager = jref.csr_quantize2d_ref(jnp.asarray(v), jnp.asarray(s))[1]
    _same_bits(np.asarray(eager), absmax / np.float32(127.0))


def test_rounding_is_half_to_even_on_v_times_inverse():
    """q = rint(v * (1 / scale)): ties go to even, and values whose
    product and quotient round apart follow the product."""
    scale_row = np.float32(127.0) * np.float32(1.0 / 127.0)
    v = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.0, 0.0]],
                 np.float32)
    got = ref.csr_quantize2d_ref(torch.from_numpy(v),
                                 torch.tensor([8], dtype=torch.int32))
    inv = np.float32(1.0) / scale_row
    want = np.clip(np.round(v * inv), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(got[0].numpy()[0, 1:6], [0, 2, 2, 0, -2])


@pytest.mark.parametrize("K,n", [(3, 5213), (2, 1024), (1, 7)])
def test_pack_unpack_round_trip(K, n):
    """Offsets + block counts give the stored columns back; both halves
    equal the reference's oracles."""
    rng = np.random.default_rng(n)
    v, i, s = _payload(rng, K, n, keep=0.5)
    if K > 1:
        s[1] = s[1] // 2
    offs, counts = ref.csr_pack_indices_ref(i, s, n)
    joffs, jcounts = jref.csr_pack_indices_ref(jnp.asarray(i.numpy()),
                                               jnp.asarray(s.numpy()), n)
    _same_bits(offs.numpy(), np.asarray(joffs))
    _same_bits(counts.numpy(), np.asarray(jcounts))
    cols = ref.csr_unpack_indices_ref(offs, counts)
    _same_bits(cols.numpy(), np.asarray(jref.csr_unpack_indices_ref(
        joffs, jcounts)))
    for k in range(K):
        live = int(s[k])
        np.testing.assert_array_equal(cols[k, :live].numpy(),
                                      i[k, :live].numpy())


@pytest.mark.parametrize("q_dtype", ["int8", "fp16"])
def test_dequantizing_decodes_match_reference(q_dtype):
    """The receiver's csr_q decode (unpacked columns, ``q * scale``) equals
    the reference's scatter-free twin, ``quantize_dense_ref`` of the capped
    mask, and ``csr_dequantize_ref`` / ``quantize_dense_ref`` equal theirs."""
    rng = np.random.default_rng(3)
    n, cap = 4000, 700
    x = rng.standard_normal((3, n)).astype(np.float32) * 1e-3
    thr = np.quantile(np.abs(x), 0.8, axis=1).astype(np.float32)
    xt, tt = torch.from_numpy(x), torch.from_numpy(thr)
    v, i, nnz = ref.csr_compact2d_ref(xt, tt, cap)
    s = torch.clamp(nnz, max=cap)
    q, offs, counts, scales = ops.csr_quantize(v, i, s, n, q_dtype=q_dtype)
    got = tsc.csr_q_decode(q, offs, counts, scales, s, n)
    dense, _ = jref.csr_capped_mask_ref(jnp.asarray(x), jnp.asarray(thr),
                                        cap)
    want = jref.quantize_dense_ref(dense, jnp.asarray(scales.numpy()),
                                   q_dtype=q_dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.quantize_dense_ref(torch.tensor(np.asarray(dense)), scales,
                               q_dtype=q_dtype).numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.csr_dequantize_ref(q, scales).numpy(),
        np.asarray(jref.csr_dequantize_ref(jnp.asarray(q.numpy()),
                                           jnp.asarray(scales.numpy()))))


def test_csr_quantize_rejects_bad_inputs():
    v = torch.zeros((2, 8))
    i = torch.zeros((2, 8), dtype=torch.int32)
    s = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="q_dtype"):
        ops.csr_quantize(v, i, s, 16, q_dtype="int4")
    with pytest.raises(TypeError, match="int32"):
        ops.csr_quantize(v, i.long(), s, 16)
    with pytest.raises(ValueError, match="disagree"):
        ops.csr_quantize(v, i[:, :4].contiguous(), s, 16)
    with pytest.raises(ValueError, match="positive"):
        ops.csr_quantize(v, i, s, 0)


def test_csr_q_blend_matches_reference():
    """``blend_flat_csr_q`` (dequantizing weighted scatter plus base sum)
    against the reference's jnp blend, at float32 rounding."""
    rng = np.random.default_rng(7)
    n = 6000
    base = rng.standard_normal((4, n)).astype(np.float32) * 0.1
    new = base + rng.standard_normal(base.shape).astype(np.float32) * 1e-3
    server = rng.standard_normal(n).astype(np.float32) * 0.1
    w, fw = np.array([0.1, 0.4, 0.3, 0.2]), 0.37
    jc = jsc.SparseComm("p0.2", use_kernel=False, wire_format="csr_q")
    jpay, _, _ = jc.csr_core(False)(jnp.asarray(new), jnp.asarray(base))
    want = jagg.blend_flat_csr_q(jnp.asarray(server), jnp.asarray(base),
                                 *jpay, jnp.asarray(w, jnp.float32),
                                 jnp.float32(fw))
    tc = tsc.SparseComm("p0.2", wire_format="csr_q")
    tpay, tst, _ = tc.csr_core(torch.from_numpy(new), torch.from_numpy(base))
    for g, j in zip(tpay, jpay):
        _same_bits(g.numpy(), np.asarray(j))
    got = tagg.blend_flat_csr_q(torch.from_numpy(server),
                                torch.from_numpy(base), *tpay, tst, w, fw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                               rtol=1e-6)
    scat = tagg.csr_q_weighted_scatter(*tpay, tst, torch.tensor(
        w, dtype=torch.float32), n)
    np.testing.assert_allclose(scat.numpy(), np.asarray(
        jagg.csr_q_weighted_scatter(*jpay, jnp.asarray(w, jnp.float32), n)),
        atol=1e-9, rtol=1e-6)


@pytest.mark.parametrize("q_dtype", ["int8", "fp16"])
def test_csr_q_ledger_and_store_booking_match_reference(q_dtype):
    """Stored elements at 1 + 2 (fp16: 2 + 2) bytes, per-row scales (none
    in fp16) and block tables, one row_ptr a batch; the base store books
    the same framing per chain transition. Every component equals the
    reference's."""
    rng = np.random.default_rng(5)
    n = 3000
    flats = [rng.standard_normal(n).astype(np.float32) * 1e-2
             for _ in range(4)]
    tc = tsc.SparseComm("p0.2", wire_format="csr_q", q_dtype=q_dtype)
    jc = jsc.SparseComm("p0.2", use_kernel=False, wire_format="csr_q",
                        q_dtype=q_dtype)
    tstore = tbs.VersionedBaseStore(torch.from_numpy(flats[0]), 5, 2)
    jstore = jbs.VersionedBaseStore(jnp.asarray(flats[0]), 5, 2)
    batch = np.stack(flats[1:])
    _, tstats = tc.encode_batch(torch.from_numpy(batch),
                                torch.zeros((3, n)))
    _, jstats = jc.encode_batch(jnp.asarray(batch), jnp.zeros((3, n)))
    np.testing.assert_array_equal(tstats["nnz"].numpy(),
                                  np.asarray(jstats["nnz"]))
    prev_t, prev_j = torch.from_numpy(flats[0]), jnp.asarray(flats[0])
    for v, targets in ((1, [0, 1]), (2, [0, 2, 3]), (3, [4])):
        new = flats[v]
        tpay, tst, tdec = tc.csr_core(torch.from_numpy(new)[None],
                                      prev_t[None])
        jpay, jst, jdec = jc.csr_core(False)(jnp.asarray(new)[None],
                                             prev_j[None])
        np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
        prev_t, prev_j = prev_t + tdec[0], prev_j + jdec[0]
        tstore.advance(prev_t, {**dict(zip(
            ("qvals", "qoffs", "qcnt", "scale"), (p[0] for p in tpay))),
            "stored": tst[0]}, v)
        jstore.advance(prev_j, {**dict(zip(
            ("qvals", "qoffs", "qcnt", "scale"), (p[0] for p in jpay))),
            "stored": jst[0]}, v)
        tstore.account_distribution(tc, targets)
        jstore.account_distribution(jc, targets)
    assert tc.wire_breakdown() == jc.wire_breakdown()
    assert (tc.aco, tc.messages, tc.dense_bytes) == \
        (jc.aco, jc.messages, jc.dense_bytes)
    assert tstore.dist_payload_bytes() == jstore.dist_payload_bytes()
    assert tstore.bytes() == jstore.bytes()   # detach flags too
    if q_dtype == "fp16":
        assert tc.scales_bytes == 0

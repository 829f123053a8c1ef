"""The chunked parameter axis in the port, on the CPU, against the JAX
package: the comm layer's chunk plan, chunked encode and chunked ring
advance against ``SparseComm(use_kernel=False, layout=...)`` (jitted, as
the reference's round bodies run them) bit for bit, with a chunk narrower
than one 512-column block and ragged widths; and whole chunked trainers
(sequential and batched engines, csr and csr_q + EF, resident and paged
stores) against the reference's chunked sequential engine, from the
reference's own initial weights on a reduced CNN with dropout 0.

Criteria against the reference: schedules exact; the byte ledger's
framing (messages, dense bytes, row_ptr, scales, block tables) and
``wire_breakdown()["layout"]`` exact; on csr without EF metrics within
1e-6, and parameters within atol 1e-6 / rtol 1e-5 but for at most
``TIE_ELEMS`` elements, none off by more than 1e-4, the stored elements
within ``TIE_ELEMS``. The two packages' stacked epochs round differently
(~1e-8), and Adam's first steps move a layer's parameters by nearly equal
magnitudes, so within a chunk as narrow as the reduced CNN's 16-wide
``dense_b`` the per-row top-k picks between near-ties differently: measured,
15 of 10,385 parameters outside atol 1e-6 / rtol 1e-5 after two rounds (14
of them ``dense_b``), at most 8.4e-5 off, 20 stored elements of 52,587
apart, metrics equal. On csr_q + EF the cross-engine bounds of
``tests/test_torch_ef.py`` (atol 1e-4 / rtol 1e-3, metrics 1e-4, ACO 2e-3,
stored elements within 1e-3). Within the port: the chunked sequential run
is the chunked batched run bit for bit, a paged run its resident twin, and
a one-chunk layout the flat run."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.core import sparse_comm as jsc  # noqa: E402
from repro.core.param_layout import ParamLayout as JLayout  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import ParamLayout  # noqa: E402
from repro_torch.core import sparse_comm as tsc  # noqa: E402
from repro_torch.core.client_store import (PagedClientStore,  # noqa: E402
                                           ResidentStore)
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402

# ragged chunks: one narrower than a 512-column block, one a block and a
# bit, one of several blocks with a ragged tail; overrides on two
BOUNDS = ((0, 300), (300, 813), (813, 2653))
KEEPS = (0.5, None, 0.35)
RESIDUALS = (None, 0.5, None)
WIRES = {"csr": {}, "csr_q": {"wire_format": "csr_q"},
         "csr_q_fp16": {"wire_format": "csr_q", "q_dtype": "fp16"}}


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    ops.reset_launches()
    yield
    # a CPU tensor never reaches a kernel
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def _channels(wire, threshold="p0.2"):
    kw = dict(bounds=BOUNDS, keep_frac=KEEPS, residual_frac=RESIDUALS)
    tc = tsc.SparseComm(threshold, layout=ParamLayout(n=2653, **kw),
                        **WIRES[wire])
    jc = jsc.SparseComm(threshold, use_kernel=False,
                        layout=JLayout(n=2653, **kw), **WIRES[wire])
    return tc, jc


def _bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        got = got.view(f"i{got.itemsize}")
        want = want.view(f"i{want.itemsize}")
    np.testing.assert_array_equal(got, want)


def _stacks(seed, K=3, n=2653):
    rng = np.random.default_rng(seed)
    new = rng.standard_normal((K, n)).astype(np.float32) * 1e-2
    base = new + rng.standard_normal((K, n)).astype(np.float32) * 1e-3
    base[:, ::7] = new[:, ::7]          # exact zeros in the delta
    return new, base


@pytest.mark.parametrize("threshold", ["p0.2", 2e-3])
@pytest.mark.parametrize("capacity", [None, 40])
def test_chunk_plan_is_the_references(threshold, capacity):
    tc, jc = _channels("csr", threshold)
    tc.capacity = jc.capacity = capacity
    assert tc.chunk_plan() == jc.chunk_plan()
    assert tc.residual_capacity_total() == jc.residual_capacity_total()
    for n in (2653, 2652, 100):
        assert tc.row_overhead_bytes(n) == jc.row_overhead_bytes(n)
        assert tc._layout_chunks(n) == jc._layout_chunks(n)
    # a channel without a layout books the flat framing
    for c in (tsc.SparseComm(threshold, capacity=capacity),
              jsc.SparseComm(threshold, use_kernel=False,
                             capacity=capacity)):
        assert c._layout_chunks(2653) == 1
        with pytest.raises(ValueError, match="requires a layout"):
            c.chunk_plan()


@pytest.mark.parametrize("wire", list(WIRES))
def test_chunk_encode_is_the_references(wire):
    """Without a residual: per-chunk payloads (chunk-local columns),
    stored counts and decodes, bit for bit; the decodes kept, then handed
    to a sink (as the trainer's upload does) and not kept."""
    tc, jc = _channels(wire)
    new, base = _stacks(1)
    tb = torch.from_numpy(base)
    body = tc.chunk_encode_body(False)
    got = body(torch.from_numpy(new), lambda s, e: tb[:, s:e])
    want = jax.jit(jc.chunk_encode_body(False))(jnp.asarray(new),
                                                jnp.asarray(base))
    for tp, jp in zip(got[0], want[0], strict=True):
        for a, b in zip(tp, jp, strict=True):
            _bits(a, b)
    for a, b in zip(got[1] + got[2], want[1] + want[2], strict=True):
        _bits(a, b)
    sunk = []
    again = body(torch.from_numpy(new), lambda s, e: tb[:, s:e],
                 sink=lambda p, d: sunk.append((p["s"], d)))
    assert again[2] == []
    assert [s for s, _ in sunk] == [p["s"] for p in tc.chunk_plan()]
    for (_, a), b in zip(sunk, want[2], strict=True):
        _bits(a, b)
    # two encodes of K rows booked per chunk: stored over columns
    share = tc.chunk_stored_share()["upload"]
    for c, p in enumerate(tc.chunk_plan()):
        assert share[c] == 2 * int(np.asarray(want[1][c]).sum()) / (
            2 * new.shape[0] * p["nc"])


@pytest.mark.parametrize("wire", list(WIRES))
def test_chunk_encode_with_residual_is_the_references(wire):
    """Two encodes with the residual pages carried (GLOBAL columns) and
    the base given as a column-gather callable: payloads, decodes and the
    new pages bit for bit."""
    tc, jc = _channels(wire)
    rtot = tc.residual_capacity_total()
    tv = torch.zeros((3, rtot))
    ti = torch.zeros((3, rtot), dtype=torch.int32)
    jv, ji = jnp.asarray(tv.numpy()), jnp.asarray(ti.numpy())
    jbody = jax.jit(jc.chunk_encode_body(True))
    for seed in (2, 3):
        new, base = _stacks(seed)
        tb = torch.from_numpy(base)
        got = tc.chunk_encode_body(True)(torch.from_numpy(new),
                                         lambda s, e: tb[:, s:e], tv, ti)
        want = jbody(jnp.asarray(new), jnp.asarray(base), jv, ji)
        for tp, jp in zip(got[0], want[0], strict=True):
            for a, b in zip(tp, jp, strict=True):
                _bits(a, b)
        for a, b in zip(got[1] + got[2], want[1] + want[2], strict=True):
            _bits(a, b)
        (tv, ti), (jv, ji) = got[3], want[3]
        _bits(tv, jv)
        _bits(ti, ji)
        assert bool((tv != 0).any())
        # each chunk's segment holds only that chunk's columns
        for p in tc.chunk_plan():
            seg = slice(p["roff"], p["roff"] + p["rcap"])
            live = tv[:, seg] != 0
            cols = ti[:, seg][live]
            assert bool(((cols >= p["s"]) & (cols < p["e"])).all())


@pytest.mark.parametrize("wire", list(WIRES))
def test_chunk_advance_is_the_references(wire):
    """The chain entry bit for bit; the reconstruction too, except on the
    int8 csr_q wire, where XLA contracts ``prev + q * scale`` into one
    fused multiply-add and the port rounds the dequantized product first:
    there the reference's is the fused form of the port's chain and the
    port's the rounded one, each bit for bit."""
    tc, jc = _channels(wire)
    new, base = _stacks(4, K=1)
    trec, tchain = tc.chunk_advance_body()(torch.from_numpy(new[0]),
                                           torch.from_numpy(base[0]))
    jrec, jchain = jax.jit(jc.chunk_advance_body())(jnp.asarray(new[0]),
                                                    jnp.asarray(base[0]))
    if wire == "csr_q":
        prev = base[0]
        fused, rounded = prev.astype(np.float64), prev.copy()
        q, offs, cnt, scales, _ = tchain
        qo = bo = 0
        for c, p in enumerate(tc.chunk_plan()):
            nblk = -(-p["nc"] // 512)
            cc = cnt[bo:bo + nblk][None]
            st = cc.sum(dim=1, dtype=torch.int32)
            cols = tsc.csr_q_columns(offs[qo:qo + p["cap"]][None], cc, st,
                                     p["nc"])[0, :int(st[0])].numpy()
            qc = q[qo:qo + int(st[0])].numpy()
            fused[p["s"] + cols] += qc.astype(np.float64) * \
                np.float64(scales[c].item())
            rounded[p["s"] + cols] += qc.astype(np.float32) * \
                scales[c].numpy()
            qo, bo = qo + p["cap"], bo + nblk
        _bits(np.asarray(jrec), fused.astype(np.float32))
        _bits(trec, rounded)
    else:
        _bits(trec, jrec)
    assert len(tchain) == len(jchain) == (5 if wire != "csr" else 3)
    for a, b in zip(tchain, jchain):
        _bits(a, b)


@pytest.mark.parametrize("wire", ["csr", "csr_q"])
def test_chunked_ledger_framing_is_the_references(wire):
    """A full-model batch books a row_ptr, and on csr_q a scale and a
    block table, per chunk; a message of another width books flat."""
    tc, jc = _channels(wire)
    for c, count in ((tc, torch.tensor), (jc, jnp.asarray)):
        c.account_batch_csr(count(7), 2653, 3)
        c.account_batch_csr(count(5), 1000, 2)
    tw, jw = tc.wire_breakdown(), jc.wire_breakdown()
    assert tw == jw
    assert tw["layout"] == ParamLayout(
        n=2653, bounds=BOUNDS, keep_frac=KEEPS,
        residual_frac=RESIDUALS).describe()


# -- whole trainers --------------------------------------------------------
SMALL = dict(conv_filters=(8, 8), hidden=16, dropout=0.0)
SCALE, ROUNDS, SEED = 0.0015, 2, 0
CHUNK = dict(chunk_size=700, layer_keep_frac={"conv": 0.5, "out": 0.5})
TIE_ELEMS = 32              # csr without EF: see the module docstring
TRAINER_WIRES = {"csr": dict(wire_format="csr"),
                 "csrq-ef": dict(wire_format="csr_q", error_feedback=True)}


@functools.lru_cache(maxsize=None)
def _init():
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    return {n: np.asarray(v) for n, v in jcnn.init_cnn(JCNN(**SMALL),
                                                       k).items()}


@functools.lru_cache(maxsize=None)
def _reference(wire):
    ref = JTrainer(j_make_dataset("basic", scale=SCALE, seed=SEED),
                   JConfig(rounds=ROUNDS, cnn=JCNN(**SMALL), seed=SEED,
                           engine="sequential", use_kernels=False,
                           **TRAINER_WIRES[wire], **CHUNK))
    return ref, ref.train()


def _port(engine, store="resident", rounds=ROUNDS, **kw):
    tr = FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                       FedS3AConfig(rounds=rounds, cnn=CNNConfig(**SMALL),
                                    seed=SEED, device="cpu", engine=engine,
                                    client_store=store, **kw),
                       init_params=_init())
    return tr, tr.train()


def _bit_equal(a, out_a, b, out_b):
    for la, lb in zip(a.logs, b.logs, strict=True):
        assert (la.participants, la.stalenesses, la.forced, la.time) == \
            (lb.participants, lb.stalenesses, lb.forced, lb.time)
    pa, pb = params_to_numpy(a.global_params), params_to_numpy(b.global_params)
    for k in pa:
        assert np.array_equal(pa[k], pb[k]), k
    assert out_a["metrics"] == out_b["metrics"]
    assert out_a["aco"] == out_b["aco"]
    assert a.comm.wire_breakdown() == b.comm.wire_breakdown()
    np.testing.assert_array_equal(a.base_versions, b.base_versions)


def _tight_gap(port, ref):
    """(parameters outside atol 1e-6 / rtol 1e-5 of the reference's, the
    largest gap)."""
    jp = {n: np.asarray(v) for n, v in ref.global_params.items()}
    tp = params_to_numpy(port.global_params)
    diff = np.concatenate([np.abs(tp[n] - jp[n]).ravel() for n in jp])
    want = np.concatenate([np.abs(jp[n]).ravel() for n in jp])
    return int((diff > 1e-6 + 1e-5 * want).sum()), float(diff.max())


def _against_reference(port, got, ref, want, wire):
    """The module docstring's criteria."""
    for a, b in zip(port.logs, ref.logs, strict=True):
        assert (a.round, a.participants, a.stalenesses, a.forced, a.time,
                a.art) == (b.round, b.participants, b.stalenesses, b.forced,
                           b.time, b.art)
    np.testing.assert_array_equal(port.base_versions, ref.base_versions)
    jp = {n: np.asarray(v) for n, v in ref.global_params.items()}
    tp = params_to_numpy(port.global_params)
    if wire == "csr":
        mtol = 1e-6
        outside, worst = _tight_gap(port, ref)
        assert outside <= TIE_ELEMS and worst <= 1e-4
    else:
        mtol = 1e-4
        for n in jp:
            np.testing.assert_allclose(tp[n], jp[n], atol=1e-4, rtol=1e-3,
                                       err_msg=n)
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) <= mtol, m
    assert got["fleet"] == want["fleet"] and got["art"] == want["art"]
    tw, jw = port.comm.wire_breakdown(), ref.comm.wire_breakdown()
    for f in ("messages", "dense_bytes", "scales_bytes",
              "block_table_bytes", "row_ptr_bytes"):
        assert getattr(port.comm, f) == getattr(ref.comm, f), f
    assert tw["layout"] == jw["layout"]
    vb, ib = port.comm.elem_bytes()
    gap = abs(tw["values_bytes"] - jw["values_bytes"]) / vb
    if wire == "csr":
        assert gap <= TIE_ELEMS
    else:
        assert gap <= 1e-3 * jw["values_bytes"] / vb
        assert abs(got["aco"] - want["aco"]) < 2e-3
    assert tw["indices_bytes"] - jw["indices_bytes"] == \
        (tw["values_bytes"] - jw["values_bytes"]) * ib / vb
    assert port.peak_delta_device_bytes() == ref.peak_delta_device_bytes()
    assert port.base_store_bytes() == ref.base_store_bytes()
    assert port.residual_store_bytes() == ref.residual_store_bytes()


@pytest.mark.parametrize("store", ["resident", "paged"])
@pytest.mark.parametrize("wire", list(TRAINER_WIRES))
def test_chunked_trainers_match_reference(wire, store):
    """Sequential and batched chunked runs: each against the reference's
    chunked sequential engine, and the two equal bit for bit."""
    ref, want = _reference(wire)
    runs = {}
    for engine in ("sequential", "batched"):
        tr, got = _port(engine, store, **TRAINER_WIRES[wire], **CHUNK)
        assert tr.engine == engine and tr.chunked and tr.stacked
        assert tr.layout.num_chunks == ref.layout.num_chunks == 18
        _against_reference(tr, got, ref, want, wire)
        runs[engine] = tr, got
    _bit_equal(*runs["sequential"], *runs["batched"])
    tr = runs["batched"][0]
    if wire == "csrq-ef":
        assert isinstance(tr.cstore, PagedClientStore if store == "paged"
                          else ResidentStore)
        assert tr.cstore.layout == "csr"
        for i in range(tr.M):
            np.testing.assert_allclose(tr.cstore.residual_row(i),
                                       _ref_residual_row(ref, i, tr.cstore.n),
                                       atol=1e-4, rtol=1e-3)


def _ref_residual_row(ref, i, n):
    out = np.zeros(n, np.float32)
    np.add.at(out, np.asarray(ref._res_idx[i]), np.asarray(ref._res_vals[i]))
    return out


@pytest.mark.parametrize("wire", list(TRAINER_WIRES))
def test_paged_chunked_equals_resident(wire):
    """tau = 0 forces stragglers every round, so pages retire."""
    kw = dict(TRAINER_WIRES[wire], **CHUNK, tau=0, rounds=3)
    res = _port("batched", "resident", **kw)
    pag = _port("batched", "paged", **kw)
    assert any(log.forced for log in pag[0].logs)
    _bit_equal(*res, *pag)
    if wire == "csrq-ef":
        for i in range(res[0].M):
            np.testing.assert_array_equal(pag[0].cstore.residual_row(i),
                                          res[0].cstore.residual_row(i))


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("wire", list(TRAINER_WIRES))
def test_single_chunk_is_the_flat_run(engine, wire):
    """A chunk size of N or more resolves to no layout: the flat path,
    bit for bit (ledger included)."""
    flat = _port(engine, **TRAINER_WIRES[wire])
    one = _port(engine, **TRAINER_WIRES[wire], chunk_size=10**7)
    assert one[0].layout is None and not one[0].chunked
    assert one[0].comm.wire_breakdown()["layout"] == {"num_chunks": 1}
    _bit_equal(*flat, *one)


def test_dropping_the_conv_override_fails_the_bound():
    """A planted fault: the port run without the ``conv`` keep override
    fails the csr criteria that hold with it, on the parameters alone (and
    on the framing: one chunk fewer)."""
    ref, want = _reference("csr")
    tr, got = _port("batched", wire_format="csr", chunk_size=700,
                    layer_keep_frac={"out": 0.5})
    outside, worst = _tight_gap(tr, ref)
    assert outside > TIE_ELEMS and worst > 1e-4
    with pytest.raises(AssertionError):
        _against_reference(tr, got, ref, want, "csr")


def test_launch_counts_split_by_shape():
    """The wrappers' launch counter: each launch adds one to its kernel's
    count and one to its (rows, width) entry; a reset clears both."""
    for shape in ((6, 99_072), (6, 99_072), (1, 99_072)):
        ops._counted("csr_compact", *shape)
    assert ops.LAUNCHES["csr_compact"] == 3
    assert ops.LAUNCHES_BY_SHAPE == {("csr_compact", 6, 99_072): 2,
                                     ("csr_compact", 1, 99_072): 1}
    ops.reset_launches()
    assert ops.LAUNCHES_BY_SHAPE == {}
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}

"""The port's msgpack checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), on the CPU: each writes the other's
bytes and reads the other's files, leaf for leaf (float32, float64,
int32, int64, bool, bfloat16, 0-d arrays and Python scalars in nested
dicts and lists); the count, shape and dtype errors carry the reference's
messages; ``cast=True`` gives the reference's values; the msgpack subset
gives msgpack's own bytes; and ``fl_checkpoint_tree`` of a port trainer,
on each engine, loads with the reference's ``load_checkpoint`` into the
reference trainer's server state of the same config and engine."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402,E501
from repro_torch.checkpoint import msgpack_ckpt  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.launch.train import fl_checkpoint_tree  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(name="t", conv_filters=(8, 8), hidden=16)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trees():
    """The same tree as numpy (the reference's leaves) and as tensors (the
    port's), from one seed; bf16 from the same 16-bit words on both
    sides."""
    rng = np.random.default_rng(0)
    words = rng.integers(-2**15, 2**15, (2, 3)).astype(np.int16)
    arrays = {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f64": rng.standard_normal(5),
        "i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "i64": rng.integers(-2**40, 2**40, 3),
        "bool": rng.random(4) > 0.5,
        "wide": rng.standard_normal((200, 100)).astype(np.float32),
        "zero_d": np.asarray(1.5, np.float32),
    }
    scalars = {"int": 7, "neg": -3, "big": 2**40, "float": 0.25,
               "flag": True, "name": "run"}

    def build(arr, bf16):
        return {"a": {"w": arr["f32"], "b": arr["f64"]},
                "list": [arr["i32"], arr["i64"], [arr["bool"], bf16]],
                "more": {"wide": arr["wide"], "s": arr["zero_d"]},
                "scalars": dict(scalars)}
    np_tree = build(arrays, words.view(jnp.bfloat16))
    t_tree = build({k: torch.from_numpy(np.array(v)) for k, v in
                    arrays.items()},
                   torch.from_numpy(words.copy()).view(torch.bfloat16))
    return np_tree, t_tree


def _same(port_leaf, ref_leaf):
    if isinstance(port_leaf, torch.Tensor):
        if port_leaf.dtype == torch.bfloat16:
            a = port_leaf.view(torch.int16).numpy()
            b = np.asarray(ref_leaf).view(np.int16)
        else:
            a, b = port_leaf.numpy(), np.asarray(ref_leaf)
            assert str(a.dtype) == str(b.dtype)
        assert a.shape == b.shape and np.array_equal(a, b)
    else:
        assert type(port_leaf) is type(ref_leaf) and port_leaf == ref_leaf


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_formats_cross_read(tmp_path, writer):
    np_tree, t_tree = _trees()
    port_path, ref_path = str(tmp_path / "p.msgpack"), str(tmp_path / "r")
    save_checkpoint(port_path, t_tree)
    jsave(ref_path, np_tree)
    # the two writers give the same bytes
    assert Path(port_path).read_bytes() == Path(ref_path).read_bytes()
    path = port_path if writer == "port" else ref_path
    got_ref = jload(path, np_tree)
    got_port = load_checkpoint(path, t_tree)
    for a, b, like in zip(leaves(got_port), leaves(got_ref), leaves(t_tree)):
        _same(a, b)
        if isinstance(like, torch.Tensor):
            assert isinstance(a, torch.Tensor) and a.dtype == like.dtype
    assert not Path(path + ".tmp").exists()


def test_numpy_like_loads_numpy(tmp_path):
    np_tree, t_tree = _trees()
    path = str(tmp_path / "c.msgpack")
    save_checkpoint(path, t_tree)
    like = {k: v for k, v in np_tree.items()}
    like["list"] = [np_tree["list"][0], np_tree["list"][1],
                    [np_tree["list"][2][0], t_tree["list"][2][1]]]
    got = load_checkpoint(path, like)
    assert isinstance(got["a"]["w"], np.ndarray)
    np.testing.assert_array_equal(got["a"]["w"], np_tree["a"]["w"])
    assert isinstance(got["list"][2][1], torch.Tensor)
    assert got["scalars"] == np_tree["scalars"]


def _bad_likes(np_tree, t_tree):
    """(name, numpy like, tensor like) pairs the loaders must refuse."""
    def shrink(tree):
        out = dict(tree)
        out["scalars"] = {k: v for k, v in tree["scalars"].items()
                          if k != "name"}
        return out

    def reshape(tree, to):
        out = dict(tree, a=dict(tree["a"]))
        out["a"]["w"] = to(tree["a"]["w"])
        return out
    return {
        "count": (shrink(np_tree), shrink(t_tree)),
        "shape": (reshape(np_tree, lambda w: w.reshape(4, 3)),
                  reshape(t_tree, lambda w: w.reshape(4, 3))),
        "dtype": (reshape(np_tree, lambda w: w.astype(np.float16)),
                  reshape(t_tree, lambda w: w.to(torch.float16))),
    }


@pytest.mark.parametrize("kind", ["count", "shape", "dtype"])
def test_errors_match_the_reference(tmp_path, kind):
    np_tree, t_tree = _trees()
    path = str(tmp_path / "c.msgpack")
    save_checkpoint(path, t_tree)
    jlike, tlike = _bad_likes(np_tree, t_tree)[kind]
    with pytest.raises(ValueError) as want:
        jload(path, jlike)
    with pytest.raises(ValueError) as got:
        load_checkpoint(path, tlike)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("to", ["float16", "bfloat16", "int32", "float64"])
def test_cast(tmp_path, to):
    np_tree, t_tree = _trees()
    path = str(tmp_path / "c.msgpack")
    save_checkpoint(path, t_tree)
    jdt = jnp.bfloat16 if to == "bfloat16" else np.dtype(to)
    jlike = dict(np_tree, a=dict(np_tree["a"]))
    jlike["a"]["w"] = np_tree["a"]["w"].astype(jdt)
    tlike = dict(t_tree, a=dict(t_tree["a"]))
    tlike["a"]["w"] = t_tree["a"]["w"].to(getattr(torch, to))
    want = jload(path, jlike, cast=True)["a"]["w"]
    got = load_checkpoint(path, tlike, cast=True)["a"]["w"]
    assert got.dtype == getattr(torch, to)
    _same(got, want)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1,
    -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.5, -1e300, True, False, None, "", "x" * 31, "y" * 32, "z" * 256,
    "é" * 40000, b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {"nested": [{"a": None}, [1.0, "b"]]}],
    ids=lambda v: type(v).__name__ + str(len(v) if hasattr(v, "__len__")
                                         else v)[:12])
def test_msgpack_subset_is_msgpack(value):
    chunks = []
    msgpack_ckpt._pack(value, chunks)
    mine = b"".join(chunks)
    assert mine == msgpack.packb(value, use_bin_type=True)
    got, end = msgpack_ckpt._unpack(memoryview(mine))
    got = bytes(got) if isinstance(got, memoryview) else got
    assert end == len(mine) and got == msgpack.unpackb(mine, raw=False)


def _server_like(jt, rounds):
    """The reference's checkpoint tree of a trainer that has taken
    ``rounds`` rounds: its state's structure, shapes and dtypes are set
    when it is built, its participation matrix grows a row a round."""
    return {"global_params": jt.global_params, "server_opt": jt.server_opt,
            "participation": np.zeros((rounds, jt.M)),
            "round": jt.global_version}


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_fl_checkpoint_tree_loads_in_the_reference(tmp_path, engine):
    kw = dict(rounds=1, seed=0, engine=engine)
    tr = FedS3ATrainer(make_dataset("basic", scale=0.0015, seed=0),
                       FedS3AConfig(cnn=CNNConfig(**SMALL), device="cpu",
                                    **kw))
    tr.run_round()
    jt = JTrainer(j_make_dataset("basic", scale=0.0015, seed=0),
                  JConfig(cnn=JCNN(**SMALL), use_kernels=False, **kw))
    path = str(tmp_path / "fl.msgpack")
    tree = fl_checkpoint_tree(tr)
    save_checkpoint(path, tree)
    got = jload(path, _server_like(jt, 1))
    assert got["round"] == 1 and isinstance(got["round"], int)
    np.testing.assert_array_equal(got["participation"], tr.participation)
    for a, b in zip(leaves(tree["global_params"]),
                    leaves(got["global_params"])):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(leaves(tree["server_opt"]), leaves(got["server_opt"])):
        np.testing.assert_array_equal(a.numpy(), b)
    # and back into the port's own server state
    back = load_checkpoint(path, fl_checkpoint_tree(tr))
    assert back["round"] == 1
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(back["server_opt"]), leaves(tree["server_opt"])))


def test_port_checkpoint_and_launcher_import_no_jax_or_msgpack():
    code = textwrap.dedent("""
        import sys
        import repro_torch.checkpoint  # noqa: F401
        import repro_torch.launch.train  # noqa: F401
        import repro_torch.training.steps  # noqa: F401
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "repro", "msgpack")]
        assert not bad, bad
        print("isolated")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout

"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
``fl`` prints the lines a direct ``FedS3ATrainer`` run of the same config
gives and writes a checkpoint that loads into ``fl_checkpoint_tree``;
``lm`` trains the reduced qwen2-1.5b and prints a finite loss a step."""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.core import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fl_prints_a_direct_runs_lines_and_checkpoints(tmp_path, capsys):
    path = str(tmp_path / "fl.msgpack")
    tr = train.main(["fl", "--scale", "0.0015", "--rounds", "1", "--ckpt",
                     path, "--ckpt-every", "1", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()

    direct = FedS3ATrainer(make_dataset("basic", scale=0.0015, seed=0),
                           FedS3AConfig(rounds=1, C=0.6, tau=2, seed=0,
                                        device="cpu"))
    log = direct.run_round()
    m = direct.evaluate()
    want = [f"round {log.round:3d} art={log.art:6.1f}s "
            f"acc={m['accuracy']:.4f} f1={m['f1']:.4f} "
            f"participants={log.participants}",
            f"  checkpoint -> {path}",
            f"final acc={direct.evaluate()['accuracy']:.4f} "
            f"aco={direct.comm.aco:.2f}"]
    assert got == want

    back = load_checkpoint(path, train.fl_checkpoint_tree(direct))
    assert back["round"] == 1
    np.testing.assert_array_equal(back["participation"],
                                  direct.participation)
    for a, b in zip(leaves(back["global_params"]),
                    leaves(direct.global_params)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(back["server_opt"]),
                    leaves(train.fl_checkpoint_tree(tr)["server_opt"])):
        assert torch.equal(a, b)


def test_lm_prints_two_finite_losses(capsys):
    out = train.main(["lm", "--steps", "2", "--seq", "32", "--device",
                      "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    losses = [float(re.match(r"step (\d): loss=(\S+) \(\S+s\)$", line)
                    .group(2)) for line in lines]
    assert all(math.isfinite(x) for x in losses)
    # near ln V at random initial weights (the reduced V is 512)
    assert abs(losses[0] - math.log(512)) < 1.0
    assert out["losses"] == pytest.approx(losses, abs=1e-4)
    assert len(out["seconds"]) == 2 and out["cfg"].vocab_size == 512


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    for mode in ("fl", "lm"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main([mode])

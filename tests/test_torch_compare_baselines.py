"""The port's ``launch/compare_baselines.py`` (the twin of
``examples/compare_baselines.py``) on the CPU at a tiny scale, in a process
of its own: its five rows, each with finite metrics in range, and no
``jax`` or reference module imported. The models are cut to a reduced CNN
through the two module attributes the trainers read."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_compare_baselines_five_rows_without_jax():
    code = textwrap.dedent("""
        import json, math, sys
        from repro_torch.configs.feds3a_cnn import CNNConfig
        from repro_torch.core import baselines, feds3a
        from repro_torch.launch import compare_baselines
        small = CNNConfig(conv_filters=(4, 4), hidden=8)
        baselines.CNN_CONFIG = feds3a.CNN_CONFIG = small
        try:
            compare_baselines.main([])
        except RuntimeError as e:
            assert "CUDA is not available" in str(e), e
        else:
            raise AssertionError("the default device ran without a card")
        rows = compare_baselines.main(["--device", "cpu"])
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print(json.dumps([[n, r["metrics"], r["rounds"]] for n, r in rows]))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), EXAMPLES_ROUNDS="1",
               EXAMPLES_SCALE="0.0015", CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    rows = json.loads(res.stdout.strip().splitlines()[-1])
    assert [r[0] for r in rows] == ["FedS3A", "FedAvg-SSL-Partial",
                                    "FedAvg-SSL-All", "FedAsync-SSL",
                                    "Local-SSL (ceiling)"]
    assert [r[2] for r in rows] == [1, 1, 1, 4, 1]
    for name, metrics, _ in rows:
        assert set(metrics) == {"accuracy", "precision", "recall", "f1",
                                "fpr"}, name
        assert all(0.0 <= v <= 1.0 for v in metrics.values()), name

"""``weighted_metrics`` counts every class at once (``np.bincount``); its
results are the reference's class-by-class loop's to the last bit, at the
paper's 9 classes and at qwen2's vocabulary of 151,936."""
import numpy as np
import pytest

from repro.core.metrics import weighted_metrics as j_weighted_metrics
from repro_torch.core.metrics import weighted_metrics


@pytest.mark.parametrize("classes, n, seed", [(9, 1000, 0), (9, 7, 1),
                                              (151_936, 128, 2)])
def test_weighted_metrics_are_the_references_bit_for_bit(classes, n, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, min(classes, 40), n)
    pred = np.where(rng.random(n) < 0.7, y, rng.integers(0, classes, n))
    got = weighted_metrics(y, pred, classes)
    want = j_weighted_metrics(y, pred, classes)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k

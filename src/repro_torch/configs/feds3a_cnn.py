"""The paper's own anomaly-detection CNN (§V-B).

Two 1D-CNN layers (128 / 256 filters), flatten, dense 256 (ReLU), dropout 0.1,
dense softmax over 9 classes, on 78-dim CIC-IDS-2017 feature vectors. This is
the model used for the faithful FedS3A reproduction benchmarks (Tables V-XII).
A copy of ``repro/configs/feds3a_cnn.py``.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class CNNConfig:
    name: str = "feds3a-cnn"
    num_features: int = 78
    num_classes: int = 9
    conv_filters: tuple = (128, 256)
    conv_kernel: int = 3
    hidden: int = 256
    dropout: float = 0.1
    source: str = "FedS3A paper §V-B (CIC-IDS 2017)"


CONFIG = CNNConfig()

"""Model configurations of the port: the paper CNN (``feds3a_cnn``) and the
language models of the model zoo. Only qwen2-1.5b is registered so far;
the other architectures come with their model families (ROADMAP.md queue
3b). ``load_all()`` populates the registry."""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_configs,
    register,
)

ARCH_MODULES = ["qwen2_1_5b"]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True

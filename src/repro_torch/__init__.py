"""PyTorch / CUDA port of the FedS3A reproduction, for one NVIDIA H100.

The JAX package ``src/repro/`` is the reference this package is held
against; the port imports nothing from it. Module names mirror the
reference so each counterpart is easy to find. Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU.
"""

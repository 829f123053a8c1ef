"""Hand-written CUDA kernels for Hopper (``csrc/``), their nvcc/ctypes
loader (``build.py``), their plain PyTorch versions (``ref.py``) and the
wrappers that pick one by the tensor's device (``ops.py``)."""

"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions (``ref.py``) and the dispatcher between them (``ops.py``)."""

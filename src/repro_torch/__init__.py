"""repro_torch — the PyTorch and CUDA port of ``repro`` for one NVIDIA H100.

It keeps ``repro``'s layout and module names. It imports ``torch``, numpy and
scipy, never ``jax`` and nothing of ``repro``: the framework-free modules it
needs are copies. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

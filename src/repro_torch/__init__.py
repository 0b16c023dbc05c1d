"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``core/``, ``kernels/``, ``data/``,
``configs/``) so every module has a counterpart of the same name. It imports
torch and numpy only: the JAX package is the reference it is tested
against, never a dependency.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""

"""PyTorch + CUDA port of the RSC system, module for module beside ``repro``.

The package mirrors ``repro``'s module paths. Host-side graph and tiling
code is numpy (carried over, never imported from ``repro``); device code is
PyTorch, and the block-sparse SpMM runs through a CUDA kernel written for
Hopper (``kernels/bcoo_spmm.py`` + ``csrc/bcoo_spmm.cu``).

Entry points take an explicit ``device`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels. Asking
for ``cuda`` on a machine without one raises instead of falling back.
"""

"""PyTorch + CUDA port of the RSC system, module for module beside ``repro``.

The package mirrors ``repro``'s module paths. Host-side graph and tiling
code is numpy (carried over, never imported from ``repro``); device code is
PyTorch. The block-sparse SpMM of GNN training and serving (GCN,
GraphSAGE, GCNII), the prefill attention of LM serving and the sampled
weight gradient of LM training run through CUDA kernels written for
Hopper (``csrc/bcoo_spmm.cu``, ``csrc/flash_attention.cu``,
``csrc/gather_matmul.cu``, wrapped in ``kernels/``).

Entry points take an explicit ``device`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels. Asking
for ``cuda`` on a machine without one raises instead of falling back.
"""

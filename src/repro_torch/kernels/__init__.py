"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

``csrc/bcoo_spmm.cu`` ports the Pallas kernel
``repro.kernels.bcoo_spmm``; ``gather_matmul`` and ``flash_attention_fwd``
are still to be ported (see ROADMAP.md). Kernels build on first use, never
at import.
"""

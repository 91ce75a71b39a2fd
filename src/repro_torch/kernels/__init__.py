"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

``csrc/bcoo_spmm.cu`` ports the Pallas kernel ``repro.kernels.bcoo_spmm``
and ``csrc/flash_attention.cu`` ports ``flash_attention_fwd``;
``gather_matmul`` is still to be ported (see ROADMAP.md). Kernels build on
first use, never at import.
"""

"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

``csrc/bcoo_spmm.cu`` ports the Pallas kernel ``repro.kernels.bcoo_spmm``,
``csrc/gather_matmul.cu`` ports ``gather_matmul`` and
``csrc/flash_attention.cu`` ports ``flash_attention_fwd``: every Pallas
kernel of the reference has its hand-written counterpart. Kernels build on
first use, never at import.
"""

"""Sparse substrate: host CSR, block-COO tiling, graph topology ops."""
from repro_torch.sparse.bcoo import (BlockCOO, BlockMeta, HostBlockCOO,
                                     csr_to_bcoo, csr_to_bcoo_host,
                                     degree_sort_permutation, host_row_ptr)
from repro_torch.sparse.csr import CSR
from repro_torch.sparse.topology import degrees, mean_normalize, sym_normalize

__all__ = ["BlockCOO", "BlockMeta", "CSR", "HostBlockCOO", "csr_to_bcoo",
           "csr_to_bcoo_host",
           "degree_sort_permutation", "degrees", "host_row_ptr",
           "mean_normalize", "sym_normalize"]

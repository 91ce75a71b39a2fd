"""RSC core: plans and the block-sparse SpMM apply."""
from repro_torch.core.plan import SamplePlan, plan_row_ptr
from repro_torch.core.rsc_spmm import exact_plan, spmm_apply, spmm_stream

__all__ = ["SamplePlan", "exact_plan", "plan_row_ptr", "spmm_apply",
           "spmm_stream"]

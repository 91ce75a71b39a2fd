"""RSC core: plans, the planner and the block-sparse SpMM with its sampled
backward."""
from repro_torch.core.plan import (SamplePlan, build_plan, full_plan,
                                   plan_row_ptr)
from repro_torch.core.rsc_spmm import (exact_plan, exact_spmm, rsc_spmm,
                                       spmm_apply, spmm_stream,
                                       transpose_bcoo)

__all__ = ["SamplePlan", "build_plan", "exact_plan", "exact_spmm",
           "full_plan", "plan_row_ptr", "rsc_spmm", "spmm_apply",
           "spmm_stream", "transpose_bcoo"]

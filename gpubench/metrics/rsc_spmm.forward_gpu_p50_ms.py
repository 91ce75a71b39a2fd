"""rsc_spmm.forward_gpu_p50_ms: per ``step`` span, the summed device time
of the forward SpMMs whose ``gpu.spmm.forward`` span has its midpoint in it
(so the evaluations' SpMMs are left out); the median over steps."""
import gb_spans


def read(out):
    return gb_spans.median_inside_ms(out, "step", "gpu.spmm.forward")

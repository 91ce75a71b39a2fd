"""rsc_spmm.backward_gpu_p50_ms: per ``step`` span, the summed device time
of the backward SpMMs (``gpu.spmm.backward``: the sampled backward RSC
cuts, exact after the switch-back); the median over steps, four in five of
which are sampled."""
import gb_spans


def read(out):
    return gb_spans.median_inside_ms(out, "step", "gpu.spmm.backward")

"""step.backward_gpu_p50_ms: the median of the program's ``gpu.backward``
device spans (the autograd backward and the taps' row norms, timed on the
card by CUDA events)."""
import gb_spans


def read(out):
    return gb_spans.median_ms(out, "gpu.backward")

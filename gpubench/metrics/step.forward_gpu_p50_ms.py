"""step.forward_gpu_p50_ms: the median of the program's ``gpu.forward``
device spans (the training forward and the loss, timed on the card by CUDA
events; the profiled training records none)."""
import gb_spans


def read(out):
    return gb_spans.median_ms(out, "gpu.forward")

"""step.optimizer_gpu_p50_ms: the median of the program's
``gpu.optimizer`` device spans (Adam's update and its application, timed
on the card by CUDA events)."""
import gb_spans


def read(out):
    return gb_spans.median_ms(out, "gpu.optimizer")

"""step_mfu: the FLOPs the profiled training needs (counted from the
benchmark's graph and widths, ``gb_work``) over its wall time, as a share
of the H100's f32-accurate peak (495 TF32 TFLOP/s over 3 passes)."""
import gb_work


def read(out):
    prof, work = out.get("profile"), out.get("work")
    if not prof or not work:
        return None
    return 100.0 * work["flops"] / prof["wall_s"] / gb_work.PEAK_FLOPS

"""bcoo_spmm_roofline: the least time of the profiled training's SpMM
work (each launch: FLOPs over the f32-accurate peak or bytes over the
bandwidth, the larger; counted from the benchmark's graph and widths)
over the device time of the program's bcoo_spmm kernels."""
import gb_devtrace


def read(out):
    prof, work = out.get("profile"), out.get("work")
    if not prof or not work:
        return None
    t = gb_devtrace.kernel_s(prof["by_name"], gb_devtrace.BCOO_SPMM)
    return 100.0 * work["spmm_least_s"] / t if t > 0 else None

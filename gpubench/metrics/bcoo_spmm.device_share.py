"""bcoo_spmm.device_share: the bcoo_spmm kernels' share of all device time
in the profiled training."""
import gb_devtrace


def read(out):
    prof = out.get("profile")
    if not prof:
        return None
    total = sum(prof["by_name"].values())
    t = gb_devtrace.kernel_s(prof["by_name"], gb_devtrace.BCOO_SPMM)
    return 100.0 * t / total if t > 0 else None

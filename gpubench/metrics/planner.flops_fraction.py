"""planner.flops_fraction: the mean over the window's finished trainings
of ``Engine.train``'s ``flops_fraction`` (backward tiles kept over all
tiles, the program's own ratio)."""
import statistics


def read(out):
    if not out["cell"]["traffic"]["rsc"]:
        return None
    v = [t["flops_fraction"] for t in out["trainings"]
         if t["done"] and t["flops_fraction"] is not None]
    return statistics.fmean(v) if v else None

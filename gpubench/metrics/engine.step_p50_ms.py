"""engine.step_p50_ms: the median step over the window, from the program's
``step`` spans (the engine's host clock around a step, ending at the
loss's one read back; the same interval as ``engine.step_ms``)."""
import statistics


def read(out):
    steps = [(b - a) * 1e3 for n, a, b in out.get("spans", ()) if n == "step"]
    return statistics.median(steps) if steps else None

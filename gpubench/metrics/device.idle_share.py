"""device.idle_share: the share of the profiled training's wall time in
which no device activity ran (the union of the trace's intervals)."""


def read(out):
    prof = out.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])

"""planner.plan_share: the program's ``plan`` spans (the host planner:
block scores, Alg. 1, plan upload) as a share of the trainings' time in
the window."""


def read(out):
    if "spans" not in out:
        return None
    s = sum(b - a for n, a, b in out["spans"] if n == "plan")
    return 100.0 * s / out["trained_s"] if s > 0 else None

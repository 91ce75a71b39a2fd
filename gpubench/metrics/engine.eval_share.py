"""engine.eval_share: the program's ``eval`` spans (every 10 epochs and
the last) as a share of the trainings' time in the window."""


def read(out):
    if "spans" not in out:
        return None
    s = sum(b - a for n, a, b in out["spans"] if n == "eval")
    return 100.0 * s / out["trained_s"] if s > 0 else None

"""step.host_issue_p50_ms: per ``device_step`` span, its duration less the
``loss_read`` inside it: the host's time to issue a step's work; the
median over steps."""
import statistics

import gb_spans


def read(out):
    s = [d - r for d, r in gb_spans.inside(out, "device_step", "loss_read")]
    return statistics.median(s) if s else None

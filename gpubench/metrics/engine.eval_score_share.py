"""engine.eval_score_share: the program's ``eval.score`` spans (the
accuracy computed on the host from the evaluation's logits) as a share of
the trainings' time in the window."""
import gb_spans


def read(out):
    return gb_spans.share(out, "eval.score")

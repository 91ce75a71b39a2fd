"""Full-batch GNN training as a configuration of the Engine.

The port of ``repro.train.loop``. Per paper §6.1: the allocator (Alg. 1)
re-runs every 10 steps, plans are cached and reused in between (§3.3.1),
approximation is active for the first 80% of epochs, then the steps switch
back to exact ops (§3.3.2). Loop mechanics live in
:mod:`repro_torch.train.engine`.
"""
from __future__ import annotations

from repro_torch.train.engine import Engine, TrainConfig, full_batch_engine

__all__ = ["GNNTrainer", "TrainConfig"]


class GNNTrainer:
    """Paper-faithful full-batch trainer (+RSC): GCN, GraphSAGE, GCNII.

    ``model`` replaces the seeded initial parameters (see ``Engine``).
    """

    def __init__(self, cfg: TrainConfig, graph, *, model=None):
        self.cfg = cfg
        self.graph = graph
        self.engine: Engine = full_batch_engine(cfg, graph, model=model)

    # The reference's accessors (its examples and benches reach for these).
    @property
    def params(self):
        return self.engine.model

    @property
    def ops(self):
        return self.engine.source.ops

    @property
    def cache(self):
        """The planner's ``PlanCache`` (None without RSC)."""
        return getattr(self.engine.planner, "cache", None)

    @property
    def schedule(self):
        return self.engine.schedule

    @property
    def history(self):
        return self.engine.history

    def train(self, epochs: int | None = None, eval_every: int = 10,
              verbose: bool = False) -> dict:
        return self.engine.train(epochs=epochs, eval_every=eval_every,
                                 verbose=verbose)

    def evaluate(self, mfn=None) -> tuple[float, float]:
        return self.engine.evaluate(mfn)

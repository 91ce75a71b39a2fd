"""Switch-back schedule (paper §3.3.2) + refresh cadence (§3.3.1).

A copy of ``repro.core.schedule``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RSCSchedule:
    """When to approximate, when to refresh plans, when to switch back.

    Paper defaults: RSC for the first 80% of training, plan refresh and
    allocator rerun every 10 steps.
    """

    total_steps: int
    rsc_fraction: float = 0.8
    refresh_every: int = 10
    allocate_every: int = 10

    def use_rsc(self, step: int) -> bool:
        if self.rsc_fraction >= 1.0:
            return True
        return step < int(self.total_steps * self.rsc_fraction)

    def refresh_due(self, step: int) -> bool:
        return self.use_rsc(step) and (step % self.refresh_every == 0)

    def allocate_due(self, step: int) -> bool:
        return self.use_rsc(step) and (step % self.allocate_every == 0)

    def mode(self, step: int) -> str:
        """Ledger/trace label for this step: ``"rsc"`` or ``"exact"``."""
        return "rsc" if self.use_rsc(step) else "exact"

    def switch_step(self) -> int:
        return int(self.total_steps * self.rsc_fraction)

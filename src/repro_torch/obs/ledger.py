"""The approximation ledger's hook, with no effect yet.

``repro.obs.ledger`` audits every allocator run (cost against budget, per
layer and epoch). The port keeps the call site — ``PlanCache.refresh``
calls ``get_ledger().note_allocation(...)`` as the reference does — and
records nothing until the observability stack is ported (ROADMAP.md Queue
1 item 6).
"""
from __future__ import annotations


class NullLedger:
    """A ledger that drops every event."""

    def note_allocation(self, *, scope: str, strategy: str, cost: float,
                        budget: float, k) -> None:
        pass


_LEDGER = NullLedger()


def get_ledger() -> NullLedger:
    return _LEDGER

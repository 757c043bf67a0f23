"""Simulator pieces the serving path needs: the replica-speed variation
model (a copy of ``repro.sim.variation``). The event-driven platform, the
workloads and the vectorized path are not ported yet."""
from .variation import VariationModel, paper_week

__all__ = ["VariationModel", "paper_week"]

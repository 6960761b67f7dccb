"""``repro_torch.mesh`` — block ownership over a grid of
``torch.distributed`` ranks (port of ``repro.mesh``'s plan geometry)."""

from repro_torch.mesh.plan import MeshPlan, current_rank, plan_rank

__all__ = ["MeshPlan", "current_rank", "plan_rank"]

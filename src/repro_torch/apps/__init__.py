"""Data-analytics applications running on the two-level storage system."""

from repro_torch.apps.terasort import TeraSortTimings, teragen, terasort, teravalidate

__all__ = ["TeraSortTimings", "teragen", "terasort", "teravalidate"]

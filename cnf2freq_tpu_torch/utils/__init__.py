"""Host-side utilities of the port."""

from .harness import mask_markers, run_experiment, score_recovery
from .simulate import simulate_f2

__all__ = ["simulate_f2", "mask_markers", "score_recovery",
           "run_experiment"]

"""Host-side utilities of the port."""

from .simulate import simulate_f2

__all__ = ["simulate_f2"]

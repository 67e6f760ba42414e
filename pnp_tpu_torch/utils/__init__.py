"""Host-side utilities: phase timers and the profiler hook, analytic test
functors, mesh debug printing."""

from .profiling import PhaseTimer, Counters
from .analytic import parabolic_potential, zero_force
from .grid_debug import describe_mesh

__all__ = ["PhaseTimer", "Counters", "parabolic_potential", "zero_force",
           "describe_mesh"]

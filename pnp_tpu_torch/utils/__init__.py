"""Host-side utilities: phase timers and the profiler hook."""

"""The benchmark of ``pnp_tpu_torch`` (see ``harness.py`` and PERF.md)."""

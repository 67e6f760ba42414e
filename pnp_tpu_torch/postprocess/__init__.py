"""Post-processing (ion currents)."""

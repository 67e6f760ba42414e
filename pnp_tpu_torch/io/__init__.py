"""Output writers and checkpoints."""

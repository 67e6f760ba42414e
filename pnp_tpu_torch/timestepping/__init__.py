"""Time-stepping tableaux."""

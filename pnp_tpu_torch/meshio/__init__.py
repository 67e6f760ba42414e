"""Mesh ingestion (numpy)."""

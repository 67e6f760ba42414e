"""Finite-element core: reference elements, spaces, constraints, tables, assembly."""

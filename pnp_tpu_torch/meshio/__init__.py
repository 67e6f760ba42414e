"""Mesh ingestion (numpy)."""

from .mesh import Mesh, LOCAL_EDGES
from .gmsh import read_gmsh

__all__ = ["Mesh", "LOCAL_EDGES", "read_gmsh"]

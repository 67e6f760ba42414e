"""ctypes bridge to the native meshkit (native/meshkit.cpp).

Builds lazily with make on first use. Where the library cannot be built
or loaded (no C++ toolchain), :func:`native_available` returns ``False``
and :func:`read_gmsh_native` raises: the caller then reads the file with
the numpy parser (gmsh.py), which returns the same :class:`Mesh` (asserted
equal in tests). This concerns a host-side mesh parser only.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from .mesh import Mesh

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libmeshkit.so"))
_lib = None
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-s"], cwd=os.path.abspath(_NATIVE_DIR),
                           check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.mk_read.restype = ctypes.c_void_p
        lib.mk_read.argtypes = [ctypes.c_char_p]
        lib.mk_error.restype = ctypes.c_char_p
        lib.mk_error.argtypes = [ctypes.c_void_p]
        for name in ("mk_num_nodes", "mk_num_tris", "mk_num_edges"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.mk_free.argtypes = [ctypes.c_void_p]
        for name in ("mk_copy_tris", "mk_copy_tri_phys", "mk_copy_edges",
                     "mk_copy_edge_phys", "mk_copy_edge_tri",
                     "mk_copy_edge_local"):
            getattr(lib, name).argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.mk_copy_nodes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.mk_partition.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except Exception:
        _lib_failed = True
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def _i32(n):
    return np.empty(n, dtype=np.int32)


def read_gmsh_native(path: str) -> Mesh:
    lib = _load()
    if lib is None:
        raise RuntimeError("native meshkit unavailable (no toolchain?)")
    h = lib.mk_read(path.encode())
    try:
        N = lib.mk_num_nodes(h)
        E = lib.mk_num_tris(h)
        B = lib.mk_num_edges(h)
        if N == 0:
            raise ValueError(
                f"meshkit: {lib.mk_error(h).decode() or 'parse failed'}")
        nodes = np.empty((N, 2), dtype=np.float64)
        tris, tri_phys = _i32((E, 3)), _i32(E)
        edges, edge_phys = _i32((B, 2)), _i32(B)
        edge_tri, edge_local = _i32(B), _i32(B)
        P_d = ctypes.POINTER(ctypes.c_double)
        P_i = ctypes.POINTER(ctypes.c_int32)
        lib.mk_copy_nodes(h, nodes.ctypes.data_as(P_d))
        lib.mk_copy_tris(h, tris.ctypes.data_as(P_i))
        lib.mk_copy_tri_phys(h, tri_phys.ctypes.data_as(P_i))
        lib.mk_copy_edges(h, edges.ctypes.data_as(P_i))
        lib.mk_copy_edge_phys(h, edge_phys.ctypes.data_as(P_i))
        lib.mk_copy_edge_tri(h, edge_tri.ctypes.data_as(P_i))
        lib.mk_copy_edge_local(h, edge_local.ctypes.data_as(P_i))
        mesh = Mesh(nodes=nodes, tris=tris, tri_phys=tri_phys, edges=edges,
                    edge_phys=edge_phys, edge_tri=edge_tri,
                    edge_local=edge_local)
        mesh.validate()
        return mesh
    finally:
        lib.mk_free(h)


def partition_elements(path: str, nparts: int):
    """Locality-preserving element permutation + part offsets (native BFS)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native meshkit unavailable")
    h = lib.mk_read(path.encode())
    try:
        E = lib.mk_num_tris(h)
        perm = _i32(E)
        offsets = _i32(nparts + 1)
        P_i = ctypes.POINTER(ctypes.c_int32)
        lib.mk_partition(h, nparts, perm.ctypes.data_as(P_i),
                         offsets.ctypes.data_as(P_i))
        return perm, offsets
    finally:
        lib.mk_free(h)

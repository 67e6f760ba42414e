"""ctypes bridge to the port's native meshkit (``csrc/meshkit.cpp``).

At first use the host C++ compiler (``$CXX``, else ``c++``) builds it into
``pnp_tpu_torch/_build/meshkit-<hash>/libmeshkit.so``, keyed on a hash of
the source and the flags, and ``ctypes`` loads it; nothing is built at
import. Where the library cannot be built or loaded (no C++ toolchain),
:func:`native_available` returns ``False`` and :func:`read_gmsh_native`
raises: the caller then reads the file with the numpy parser (gmsh.py),
which returns the same :class:`Mesh` (asserted equal in tests). This
concerns a host-side mesh parser only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Optional

import numpy as np

from .mesh import Mesh

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "meshkit.cpp"
BUILD_ROOT = _PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_lib = None
_lib_failed = False


def build() -> pathlib.Path:
    """Compile ``csrc/meshkit.cpp`` unless built already for this source
    and these flags; the library's path."""
    cxx = os.environ.get("CXX") or "c++"
    h = hashlib.sha256(" ".join([cxx, *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / f"meshkit-{h.hexdigest()[:16]}"
    lib_path = out_dir / "libmeshkit.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libmeshkit.{os.getpid()}.so"
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp, lib_path)
        finally:
            tmp.unlink(missing_ok=True)
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
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

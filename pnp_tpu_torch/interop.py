"""Carry the reference package's data across, as numpy arrays.

The FEM analogue of loading another framework's weights: each function
takes a ``pnp_tpu`` object (or anything with the same attributes and
array-likes) and returns the port's counterpart, so both packages compute
on identical inputs. Nothing here imports ``pnp_tpu`` or ``jax``; arrays
pass through ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Surface, Sysparams
from .fem.geometry import BoundaryTables, VolumeTables, f64, index
from .fem.space import FunctionSpace
from .meshio.mesh import Mesh


def sysparams(src) -> Sysparams:
    """``pnp_tpu.config.Sysparams`` -> the port's :class:`Sysparams`."""
    kw = {f.name: getattr(src, f.name) for f in dataclasses.fields(Sysparams)
          if f.name != "surfaces"}
    kw["surfaces"] = [
        Surface(**{f.name: getattr(s, f.name)
                   for f in dataclasses.fields(Surface)})
        for s in src.surfaces]
    return Sysparams(**kw)


def mesh(src) -> Mesh:
    """``pnp_tpu.meshio.mesh.Mesh`` -> the port's :class:`Mesh`."""
    return Mesh(**{f.name: np.array(getattr(src, f.name))
                   for f in dataclasses.fields(Mesh)})


def function_space(src) -> FunctionSpace:
    """``pnp_tpu.fem.space.FunctionSpace`` -> the port's (rebuilt from the
    same mesh arrays and degree; tests pin the dof maps equal)."""
    return FunctionSpace(mesh(src.mesh), int(src.degree))


def volume_tables(src, device="cpu") -> VolumeTables:
    return VolumeTables(shape=f64(src.shape, device),
                        gradphi=f64(src.gradphi, device),
                        qw=f64(src.qw, device), qy=f64(src.qy, device),
                        dofmap=index(src.dofmap, device))


def boundary_tables(src, device="cpu") -> BoundaryTables:
    return BoundaryTables(shape=f64(src.shape, device),
                          qw=f64(src.qw, device), qy=f64(src.qy, device),
                          dofmap=index(src.dofmap, device),
                          flux=f64(src.flux, device),
                          neumann=f64(src.neumann, device))


def field(u, device="cpu") -> torch.Tensor:
    """A PB field or any dof vector -> f64 tensor on ``device``."""
    return f64(u, device)


def state(phi, cp, cm, device="cpu"):
    """A ``(phi, cp, cm)`` state -> three f64 tensors on ``device``."""
    return field(phi, device), field(cp, device), field(cm, device)

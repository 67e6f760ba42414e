"""Carry the reference package's data across, as numpy arrays.

The FEM analogue of loading another framework's weights: each function
takes a ``pnp_tpu`` object (or anything with the same attributes and
array-likes) and returns the port's counterpart, so both packages compute
on identical inputs: meshes, spaces, tables, fields, and the block-RAS
pieces (block context, RAS factors with their p1 coarse tables, the
Poisson inverse of the mid-size and of the very-large tier, a species
factor of either kind) so a solve can be compared with the preconditioner
held equal, the composite state of the monolithic workloads, and the
multi-device pieces (a halo plan, an owner-partitioned state). Nothing
here imports ``pnp_tpu`` or ``jax``; arrays pass through
``numpy.asarray``.
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


def block_context(src, device="cpu"):
    """``pnp_tpu.solvers.block_ras.BlockContext`` -> the port's."""
    from .solvers.block_ras import BlockContext
    return BlockContext(
        K=int(src.K), B=int(src.B), L=int(src.L),
        loc2glob=index(src.loc2glob, device),
        elem_ids=index(src.elem_ids, device),
        elem_dof_local=index(src.elem_dof_local, device),
        owner=index(src.owner, device), ndof=int(src.ndof))


def p1_coarse(src, device="cpu"):
    """p1 coarse tables ``(coarse_inv, w3, idx3)`` -> (f32, f64, int64)."""
    cinv, w3, idx3 = src
    return (torch.tensor(np.asarray(cinv, np.float32), device=device),
            f64(w3, device), index(idx3, device))


def ras_factor(src, device="cpu"):
    """A RAS factor: f32 local inverses, or ``(inverses, p1 tables)``."""
    if isinstance(src, tuple):
        return (ras_factor(src[0], device), p1_coarse(src[1], device))
    return torch.tensor(np.asarray(src, np.float32), device=device)


def poisson_inverse(src, device="cpu", ndof=None):
    """The mid-size tier's (1, N, N) f32 Poisson inverse, or the very-large
    tier's scaled pair ``(X_eq, s)``. The reference keeps that pair padded
    to a multiple of 128 (identity on the pad); ``ndof`` crops it to the
    port's unpadded size."""
    if isinstance(src, tuple):
        X_eq, s = (np.asarray(a, np.float32) for a in src)
        n = X_eq.shape[-1] if ndof is None else ndof
        return (torch.tensor(X_eq[:, :n, :n], device=device),
                torch.tensor(s[:n], device=device))
    return torch.tensor(np.asarray(src, np.float32), device=device)


def species_factor(src, device="cpu"):
    """A species factor of either kind: the dense tier's (2, N, N) f32
    stage inverses, a RAS factor, or the mid-size species tier's tagged
    pair ``("inv", inverses)`` / ``("ras", RAS factor)``."""
    if isinstance(src, tuple) and isinstance(src[0], str):
        return (src[0], ras_factor(src[1], device))
    return ras_factor(src, device)


def composite_state(u0, free, g, device="cpu"):
    """The monolithic workloads' composite state ``(u0, free, g)`` over
    3 * ndof dofs -> (f64, bool, f64) tensors."""
    return (f64(u0, device),
            torch.tensor(np.asarray(free, bool), device=device),
            f64(g, device))


def halo_plan(src):
    """``pnp_tpu.parallel.halo.HaloPlan`` -> the port's (numpy, the same
    arrays and sizes)."""
    from .parallel.halo import HaloPlan
    return HaloPlan(**{
        f.name: (int(getattr(src, f.name)) if f.type in ("int", int)
                 else np.array(getattr(src, f.name)))
        for f in dataclasses.fields(HaloPlan)})


def dist_state(uphi, uc, src_plan, ctx):
    """The reference's owner-partitioned state ``(uphi (Kb,), uc (2, Kb))``,
    laid out by its plan ``src_plan``, -> the port's on ``ctx``
    (a :class:`.parallel.dist.DistContext`): f64 tensors ``(uphi (Kb',),
    uc (2, Kb'))`` on ``ctx.device``. The plans may differ (another shard
    count): the state goes through its global form."""
    from .parallel.halo import unpartition_vector
    p = halo_plan(src_plan)
    glob = lambda v: unpartition_vector(
        p, np.asarray(v, np.float64).reshape(p.K, p.B_N))
    uc = np.asarray(uc)
    return (f64(ctx.partition(glob(uphi)), ctx.device),
            f64(np.stack([ctx.partition(glob(c)) for c in uc]), ctx.device))

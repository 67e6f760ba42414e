"""Shared workload plumbing (port of ``pnp_tpu.workloads.common``): one
context object holds the device tables every solver phase needs for one
scalar field component."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import Sysparams
from ..fem.space import FunctionSpace
from ..fem.geometry import (VolumeTables, BoundaryTables, build_volume_tables,
                            build_boundary_tables, f64)
from ..fem import constraints as C
from ..fem import assembly as A
from ..operators import boundary as OB
from ..utils.device import resolve_device


@dataclasses.dataclass
class ScalarContext:
    """Everything needed to assemble/solve one scalar field component."""

    space: FunctionSpace
    vt: VolumeTables
    bt: BoundaryTables
    component: int
    free: Any            # (ndof,) bool — not Dirichlet-constrained
    dirichlet: Any       # (ndof,) configured Dirichlet values (0 elsewhere)
    flux_vector: Any     # (ndof,) assembled Neumann flux contribution
    sys: Sysparams
    # the prepared PB element kernel (workloads/pb.py makes it at first use)
    pb_element: Any = None

    @property
    def ndof(self) -> int:
        return self.space.ndof

    @property
    def dofmap(self):
        return self.vt.dofmap

    @property
    def device(self):
        return self.free.device

    def constrain(self, r):
        return torch.where(self.free, r, 0.0)

    def scatter(self, r_el):
        return A.scatter_add(r_el, self.vt.dofmap, self.space.ndof)


def make_scalar_context(
    sys: Sysparams,
    space: FunctionSpace,
    component: int,
    quad_order: int,
    boundary_quad_order: int | None = None,
    flux_cylindrical: bool | None = None,
    device=None,
) -> ScalarContext:
    """Build tables + constraints for one field component on ``device``
    (default: the current CUDA device; raises without one).

    The quadrature order is raised to 2*degree so higher-order spaces are
    never under-integrated; ``flux_cylindrical`` (default
    ``sys.cylindrical``) sets the axisymmetric weight of the Neumann term.
    """
    device = resolve_device(device)
    mesh = space.mesh
    quad_order = max(quad_order, 2 * space.degree)
    if boundary_quad_order is None:
        boundary_quad_order = quad_order
    vt = build_volume_tables(space, quad_order, device)
    bt = build_boundary_tables(space, boundary_quad_order,
                               C.flux_table(sys, mesh),
                               C.neumann_flags(sys, mesh), device)
    free = torch.as_tensor(C.free_dof_mask(space, sys, component),
                           device=device)
    dirichlet = f64(C.dirichlet_dof_values(space, sys, component), device)
    cyl = sys.cylindrical if flux_cylindrical is None else flux_cylindrical
    r_el = OB.flux_residual_el(bt, component, cyl, sys.pi)
    flux_vector = A.scatter_add(r_el, bt.dofmap, space.ndof)
    return ScalarContext(
        space=space, vt=vt, bt=bt, component=component,
        free=free, dirichlet=dirichlet, flux_vector=flux_vector, sys=sys)

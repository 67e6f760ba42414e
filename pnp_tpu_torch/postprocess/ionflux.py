"""Per-surface ion current post-processing (port of
``pnp_tpu.postprocess.ionflux``).

Parity: reference ``calcIonFlux`` (src/ionFlux.hh:7-96): for every boundary
face, evaluate (phi, c+, c-) and their gradients at the face center and
accumulate per physical group

    ip[pg] += (-grad c+ + c+ grad phi) . n * w
    im[pg] += (-grad c- - c- grad phi) . n * w,   w = |face| (cyl: * 2 pi y)

``convention="reference"`` reproduces the reference's drift-term signs,
``convention="physical"`` uses the physically-signed fluxes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..fem.geometry import element_jacobians, f64, index
from ..fem.space import FunctionSpace
from ..meshio.mesh import LOCAL_EDGES
from ..utils.profiling import span

_REF_VERTS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


@dataclasses.dataclass(frozen=True)
class IonFluxTables:
    shape_c: Any    # (B, n) element basis at face center
    grad_c: Any     # (B, n, 2) physical basis gradients at face center
    normal: Any     # (B, 2) outward unit normal
    weight: Any     # (B,) |face| (* 2 pi y_center when cylindrical)
    dofmap: Any     # (B, n)
    edge_phys: Any  # (B,) int64
    n_surfaces: int


def build_ionflux_tables(space: FunctionSpace, cylindrical: bool,
                         pi: float, n_surfaces: int,
                         device="cpu") -> IonFluxTables:
    mesh = space.mesh
    la = LOCAL_EDGES[mesh.edge_local]                 # (B, 2) local vertices
    loc_c = 0.5 * (_REF_VERTS[la[:, 0]] + _REF_VERTS[la[:, 1]])

    shape_c = space.ref.values(loc_c)                 # (B, n)
    gref = space.ref.gradients(loc_c)                 # (B, n, 2)
    _, _, jinv_t = element_jacobians(mesh)
    grad_c = np.einsum("bad,bid->bia", jinv_t[mesh.edge_tri], gref)

    pa = mesh.nodes[mesh.edges[:, 0]]
    pb = mesh.nodes[mesh.edges[:, 1]]
    # triangle-local ordering gives a guaranteed-outward normal
    va = mesh.nodes[np.take_along_axis(mesh.tris[mesh.edge_tri], la, axis=1)]
    d = va[:, 1] - va[:, 0]                           # CCW edge direction
    length = np.linalg.norm(d, axis=1)
    normal = np.stack([d[:, 1], -d[:, 0]], axis=1) / length[:, None]

    weight = length.copy()
    if cylindrical:
        weight *= 2.0 * pi * (0.5 * (pa + pb))[:, 1]

    return IonFluxTables(
        shape_c=f64(shape_c, device), grad_c=f64(grad_c, device),
        normal=f64(normal, device), weight=f64(weight, device),
        dofmap=index(space.dofmap[mesh.edge_tri], device),
        edge_phys=index(mesh.edge_phys, device), n_surfaces=n_surfaces)


def calc_ion_flux(t: IonFluxTables, phi, cp, cm, convention: str = "reference"):
    """Returns (ip, im) tensors of shape (n_surfaces,)."""
    with span("ionflux"):
        phie, cpe, cme = phi[t.dofmap], cp[t.dofmap], cm[t.dofmap]
        cp_c = torch.einsum("bi,bi->b", cpe, t.shape_c)
        cm_c = torch.einsum("bi,bi->b", cme, t.shape_c)
        gphi = torch.einsum("bi,bia->ba", phie, t.grad_c)
        gcp = torch.einsum("bi,bia->ba", cpe, t.grad_c)
        gcm = torch.einsum("bi,bia->ba", cme, t.grad_c)
        sign = 1.0 if convention == "reference" else -1.0
        jp = -gcp + sign * cp_c[:, None] * gphi
        jm = -gcm - sign * cm_c[:, None] * gphi
        fp = torch.einsum("ba,ba->b", jp, t.normal) * t.weight
        fm = torch.einsum("ba,ba->b", jm, t.normal) * t.weight
        zeros = torch.zeros(t.n_surfaces, dtype=fp.dtype, device=fp.device)
        return (zeros.index_add(0, t.edge_phys, fp),
                zeros.index_add(0, t.edge_phys, fm))

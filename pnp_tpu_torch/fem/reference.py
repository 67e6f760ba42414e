"""Lagrange P1-P3 reference elements on the unit triangle.

Numpy copy of ``pnp_tpu.fem.reference`` (tests pin identical tables).
Replacement for ``Pk2DLocalFiniteElementMap`` basis evaluation
(bound by the reference at src/instationary_pnp_from_pb_md.hh:125, PDEGREE
1..3 per src/Makefile.am:53-111): shape values and reference gradients are
tabulated once at quadrature points and consumed as dense constants by the
batched element kernels.

Barycentric coordinates: l0 = 1-x-y, l1 = x, l2 = y; local dof order is
vertices, then (p-1) dofs per local edge (edge k = (k, (k+1)%3), ordered from
first to second vertex), then interior dofs.
"""

from __future__ import annotations

import numpy as np

_EDGE = [(0, 1), (1, 2), (2, 0)]  # must match meshio.mesh.LOCAL_EDGES


def _bary(x, y):
    return np.array([1.0 - x - y, x, y])


def _dbary():
    # d(l0,l1,l2)/d(x,y): rows = barycentric index, cols = (x, y)
    return np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


class ReferenceTriangle:
    """Shape function tables for Pk (k = 1, 2, 3) on the reference triangle."""

    def __init__(self, degree: int):
        if degree not in (1, 2, 3):
            raise ValueError("degree must be 1, 2, or 3")
        self.degree = degree
        self.ndof = {1: 3, 2: 6, 3: 10}[degree]
        self.dof_ref_coords = self._dof_coords()

    # --- dof layout -------------------------------------------------------
    def _dof_coords(self) -> np.ndarray:
        verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        coords = [verts[i] for i in range(3)]
        if self.degree == 2:
            for (i, j) in _EDGE:
                coords.append(0.5 * (verts[i] + verts[j]))
        elif self.degree == 3:
            for (i, j) in _EDGE:
                coords.append((2 * verts[i] + verts[j]) / 3.0)
                coords.append((verts[i] + 2 * verts[j]) / 3.0)
            coords.append(verts.mean(axis=0))
        return np.array(coords)

    # --- basis evaluation -------------------------------------------------
    def values(self, points: np.ndarray) -> np.ndarray:
        """Shape values at reference points (nq, 2) -> (nq, ndof)."""
        out = np.empty((points.shape[0], self.ndof))
        for q, (x, y) in enumerate(points):
            out[q] = self._eval(_bary(x, y))
        return out

    def gradients(self, points: np.ndarray) -> np.ndarray:
        """Reference gradients at points (nq, 2) -> (nq, ndof, 2)."""
        db = _dbary()  # (3, 2)
        out = np.empty((points.shape[0], self.ndof, 2))
        for q, (x, y) in enumerate(points):
            lam = _bary(x, y)
            grad_l = self._eval_grad_bary(lam)  # (ndof, 3) d/d(lambda)
            out[q] = grad_l @ db
        return out

    def _eval(self, l: np.ndarray) -> np.ndarray:
        p = self.degree
        if p == 1:
            return l.copy()
        if p == 2:
            vals = [l[i] * (2 * l[i] - 1) for i in range(3)]
            vals += [4 * l[i] * l[j] for (i, j) in _EDGE]
            return np.array(vals)
        vals = [0.5 * l[i] * (3 * l[i] - 1) * (3 * l[i] - 2) for i in range(3)]
        for (i, j) in _EDGE:
            vals.append(4.5 * l[i] * l[j] * (3 * l[i] - 1))
            vals.append(4.5 * l[i] * l[j] * (3 * l[j] - 1))
        vals.append(27 * l[0] * l[1] * l[2])
        return np.array(vals)

    def _eval_grad_bary(self, l: np.ndarray) -> np.ndarray:
        """d(shape)/d(lambda_k) as (ndof, 3)."""
        p = self.degree
        g = np.zeros((self.ndof, 3))
        if p == 1:
            for i in range(3):
                g[i, i] = 1.0
            return g
        if p == 2:
            for i in range(3):
                g[i, i] = 4 * l[i] - 1
            for n, (i, j) in enumerate(_EDGE):
                g[3 + n, i] = 4 * l[j]
                g[3 + n, j] = 4 * l[i]
            return g
        for i in range(3):
            g[i, i] = 0.5 * ((3 * l[i] - 1) * (3 * l[i] - 2)
                             + 3 * l[i] * (3 * l[i] - 2) + 3 * l[i] * (3 * l[i] - 1))
        n = 3
        for (i, j) in _EDGE:
            # 4.5 * l_i * l_j * (3 l_i - 1)
            g[n, i] = 4.5 * (l[j] * (3 * l[i] - 1) + 3 * l[i] * l[j])
            g[n, j] = 4.5 * l[i] * (3 * l[i] - 1)
            n += 1
            # 4.5 * l_i * l_j * (3 l_j - 1)
            g[n, i] = 4.5 * l[j] * (3 * l[j] - 1)
            g[n, j] = 4.5 * (l[i] * (3 * l[j] - 1) + 3 * l[i] * l[j])
            n += 1
        g[n, 0] = 27 * l[1] * l[2]
        g[n, 1] = 27 * l[0] * l[2]
        g[n, 2] = 27 * l[0] * l[1]
        return g

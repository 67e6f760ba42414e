"""Plain P1 reference of the pore transient: the PB bootstrap, the
Poisson presolve and re-solves, both species' Alexander-2 stages and the
per-surface ion currents, written from the weak forms.

Weak forms (cylindrical weight w = 2 pi r where the configuration is
cylindrical, on PB and Poisson only; the species operators carry none, as
in dune-pnp's ``diffusion_operator.hh``):

* PB:       int grad u . grad v w + 8 pi l_B c0 sinh(u) v w + int_N j v w = 0
* Poisson:  int grad phi . grad v w + 4 pi l_B (c- - c+) v w + int_N j v w = 0
* species:  m(c) = int c v,
            a_z(c) = int grad c . grad v + z c grad phi . grad v
* Alexander-2 (alpha = 1 - sqrt(2)/2), stage matrix S = M + dt alpha A_z:
  S c1 = M c0;  S c2 = M c0 - dt (1 - alpha) A_z c1
* current through a boundary face, at its centre, times |face| w:
  (-grad c+ + c+ grad phi) . n  and  (-grad c- - c- grad phi) . n

Integrals on P1 triangles: exact closed forms where the integrand is a
polynomial; ``sinh`` and ``cosh`` of PB at the degree-3 symmetric rule
(the centroid, weight -27/48, and the three points of barycentric
(0.6, 0.2, 0.2), weight 25/48), as the discretisation under test uses.
Dirichlet rows are replaced by the identity. PB (Newton) and Poisson are
solved by sparse LU (SciPy's SuperLU) on the host; each species stage by
BiCGSTAB under Jacobi on ``device``, to a residual near the precision's
floor. Everything runs in ``dtype``: float64 for the reference, float32
for the control that stands in for a program computed a precision lower.

This module imports nothing of the program under test.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

DIRICHLET = 0
_COMPONENT_KEYS = (("coulombBtype", "coulombPotential", "coulombFlux"),
                   ("plusDiffusionBtype", "plusDiffusionConcentration",
                    "plusDiffusionFlux"),
                   ("minusDiffusionBtype", "minusDiffusionConcentration",
                    "minusDiffusionFlux"))
#: the degree-3 rule in barycentric coordinates, weights summing to 1
_Q3_BARY = np.array([[1 / 3, 1 / 3, 1 / 3], [0.6, 0.2, 0.2],
                     [0.2, 0.6, 0.2], [0.2, 0.2, 0.6]])
_Q3_W = np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48])
ALPHA = 1.0 - 0.5 * math.sqrt(2.0)


def _tol(dtype) -> float:
    """Relative residual a solve in ``dtype`` is taken to: 1e-12 in
    float64, about ten ulps in float32."""
    return max(1e-12, 10.0 * float(torch.finfo(dtype).eps))


class Case:
    """The mesh, the parameters and the P1 element tables in ``dtype`` on
    ``device``; ``surfaces`` is the configuration's surface list with the
    run's bias already in it."""

    def __init__(self, mesh: dict, system: dict, surfaces: list,
                 dtype=torch.float64, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        self.l_b, self.c0, self.dt = (system["l_b"], system["c0"],
                                      system["tau"])
        self.cyl = bool(system["cylindrical"])
        nodes = np.asarray(mesh["nodes"], np.float64)
        tris = np.asarray(mesh["tris"], np.int64)
        self.N = nodes.shape[0]
        x = nodes[tris]                                        # (E, 3, 2)
        J = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]], axis=2)
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        area = 0.5 * np.abs(det)
        # gradients of the barycentric basis: rows of inv(J)^T applied to
        # the reference gradients (-1,-1), (1,0), (0,1)
        ref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        G = np.einsum("eba,ib->eia", np.linalg.inv(J), ref)    # (E, 3, 2)
        y = x[:, :, 1]
        qy = y @ _Q3_BARY.T                                    # (E, 4)
        wcyl = (2.0 * math.pi * qy if self.cyl else np.ones_like(qy))
        qf = area[:, None] * _Q3_W[None, :] * wcyl             # (E, 4)
        GG = np.einsum("eia,eja->eij", G, G)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self.G, self.area = t(G), t(area)
        self.qf = t(qf)
        self.bary = t(_Q3_BARY)
        # Poisson/PB stiffness (weighted), weighted mass, species tables
        self.K_w = t(GG * qf.sum(1)[:, None, None])
        self.M_w = t(np.einsum("eq,qi,qj->eij", qf, _Q3_BARY, _Q3_BARY))
        self.K_d = t(GG * area[:, None, None])
        self.M_p = t((np.ones((3, 3)) + np.eye(3))[None]
                     * (area / 12.0)[:, None, None])
        self.tris_t = torch.as_tensor(tris, device=self.device)

        # the CSR pattern and the map from element entries to its slots
        rows = np.repeat(tris, 3, axis=1).ravel()
        cols = np.tile(tris, (1, 3)).ravel()
        keys = rows * self.N + cols
        uniq, inv = np.unique(keys, return_inverse=True)
        self.indptr = np.searchsorted(uniq // self.N,
                                      np.arange(self.N + 1)).astype(np.int64)
        self.indices = (uniq % self.N).astype(np.int64)
        self.slot = torch.as_tensor(inv, device=self.device)
        self.nnz = uniq.size
        self.row_of = torch.as_tensor(uniq // self.N, device=self.device)
        self.diag_slot = torch.as_tensor(
            np.searchsorted(uniq, np.arange(self.N) * (self.N + 1)),
            device=self.device)
        self.crow_t = torch.as_tensor(self.indptr, device=self.device)
        self.col_t = torch.as_tensor(self.indices, device=self.device)

        # boundary conditions per component (0 phi, 1 c+, 2 c-)
        edges = np.asarray(mesh["edges"], np.int64)
        ephys = np.asarray(mesh["edge_phys"], np.int64)
        self.free, self.g = [], []
        for comp in range(3):
            btype_k, value_k, flux_k = _COMPONENT_KEYS[comp]
            dir_s = np.array([s.get(btype_k, 1) == DIRICHLET
                              for s in surfaces])
            val_s = np.array([float(s.get(value_k, 0.0)) for s in surfaces])
            on = dir_s[ephys]
            g = np.zeros(self.N)
            free = np.ones(self.N, bool)
            for e in np.nonzero(on)[0]:
                g[edges[e]] = val_s[ephys[e]]
                free[edges[e]] = False
            if comp > 0 and any(float(s.get(flux_k, 0.0)) != 0.0
                                for s in surfaces):
                raise ValueError("species boundary fluxes are not modelled")
            self.free.append(torch.as_tensor(free, device=self.device))
            self.g.append(t(g))
        # Neumann flux of phi: int_edge j v w, exact for P1 (w linear)
        flux_s = np.array([float(s.get("coulombFlux", 0.0)) for s in surfaces])
        neu = ~np.array([s.get("coulombBtype", 1) == DIRICHLET
                         for s in surfaces])[ephys]
        j = flux_s[ephys] * neu
        pa, pb = nodes[edges[:, 0]], nodes[edges[:, 1]]
        length = np.linalg.norm(pb - pa, axis=1)
        if self.cyl:
            fa = 2 * math.pi * length * (2 * pa[:, 1] + pb[:, 1]) / 6.0
            fb = 2 * math.pi * length * (pa[:, 1] + 2 * pb[:, 1]) / 6.0
        else:
            fa = fb = length / 2.0
        F = np.zeros(self.N)
        np.add.at(F, edges[:, 0], j * fa)
        np.add.at(F, edges[:, 1], j * fb)
        self.F = t(F)

        # ion-flux tables: the face centre of each boundary edge in its
        # triangle, the outward normal, |face| w
        etri = np.asarray(mesh["edge_tri"], np.int64)
        eloc = np.asarray(mesh["edge_local"], np.int64)
        v0 = tris[etri, eloc]
        v1 = tris[etri, (eloc + 1) % 3]
        d = nodes[v1] - nodes[v0]
        elen = np.linalg.norm(d, axis=1)
        normal = np.stack([d[:, 1], -d[:, 0]], axis=1) / elen[:, None]
        wface = elen * (2 * math.pi * 0.5 * (pa[:, 1] + pb[:, 1])
                        if self.cyl else 1.0)
        self.face_v = torch.as_tensor(np.stack([v0, v1], 1),
                                      device=self.device)
        self.face_tri = torch.as_tensor(etri, device=self.device)
        self.face_nw = t(normal * wface[:, None])
        self.face_phys = torch.as_tensor(ephys, device=self.device)
        self.n_surfaces = len(surfaces)

    # -- sparse assembly -------------------------------------------------
    def values(self, blocks) -> torch.Tensor:
        """CSR values of the sum of (E, 3, 3) element blocks."""
        out = torch.zeros(self.nnz, dtype=self.dtype, device=self.device)
        return out.index_add_(0, self.slot, blocks.reshape(-1))

    def constrain(self, vals, comp: int) -> torch.Tensor:
        """Dirichlet rows of component ``comp`` replaced by the identity."""
        free = self.free[comp]
        vals = torch.where(free[self.row_of], vals, 0.0)
        return vals.index_add_(0, self.diag_slot,
                               (~free).to(self.dtype))

    def scipy(self, vals):
        return sp.csr_matrix((vals.cpu().numpy(), self.indices, self.indptr),
                             shape=(self.N, self.N))

    def torch_csr(self, vals):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)    # "beta state"
            return torch.sparse_csr_tensor(self.crow_t, self.col_t, vals,
                                           (self.N, self.N))

    def scatter(self, r_el) -> torch.Tensor:
        out = torch.zeros(self.N, dtype=self.dtype, device=self.device)
        return out.index_add_(0, self.tris_t.reshape(-1), r_el.reshape(-1))

    def apply(self, blocks, u) -> torch.Tensor:
        return self.scatter(torch.einsum("eij,ej->ei", blocks,
                                         u[self.tris_t]))

    # -- PB ----------------------------------------------------------------
    def _pb_residual(self, u):
        uq = u[self.tris_t] @ self.bary.T                      # (E, 4)
        coef = 8.0 * math.pi * self.l_b * self.c0
        src = torch.einsum("eq,qi->ei", self.qf * coef * torch.sinh(uq),
                           self.bary)
        r = self.apply(self.K_w, u) + self.scatter(src) + self.F
        return torch.where(self.free[0], r, 0.0)

    def solve_pb(self, max_iter: int = 40):
        """Damped Newton from u = 0 with phi = 0 on every Dirichlet
        surface (dune-pnp's PB start, which does not interpolate the
        Dirichlet values), to the precision's residual floor. Returns
        (u, Newton iterations)."""
        tol = _tol(self.dtype)
        coef = 8.0 * math.pi * self.l_b * self.c0
        u = torch.zeros(self.N, dtype=self.dtype, device=self.device)
        r = self._pb_residual(u)
        r0 = norm = float(torch.linalg.vector_norm(r))
        it = 0
        for it in range(1, max_iter + 1):
            uq = u[self.tris_t] @ self.bary.T
            jac = self.K_w + torch.einsum(
                "eq,qi,qj->eij", self.qf * coef * torch.cosh(uq),
                self.bary, self.bary)
            A = self.scipy(self.constrain(self.values(jac), 0)).tocsc()
            du = torch.as_tensor(spla.splu(A).solve(-r.cpu().numpy()),
                                 dtype=self.dtype, device=self.device)
            lam = 1.0
            while True:
                r_new = self._pb_residual(u + lam * du)
                n_new = float(torch.linalg.vector_norm(r_new))
                if n_new < norm or lam < 1e-3:
                    break
                lam *= 0.5
            if not n_new < norm:        # at the precision's floor
                break
            u, r, norm = u + lam * du, r_new, n_new
            if norm <= tol * r0:
                break
        return u, it

    # -- Poisson ------------------------------------------------------------
    def poisson_factor(self):
        """The LU of the constrained (constant) Poisson matrix."""
        return spla.splu(self.scipy(self.constrain(
            self.values(self.K_w), 0)).tocsc())

    def poisson(self, lu, phi, cp, cm):
        """phi with the linear Poisson equation solved for the charge of
        (cp, cm); Dirichlet values are kept from ``phi``."""
        w = (4.0 * math.pi * self.l_b) * (cm - cp)
        r = (self.apply(self.K_w, phi) + self.apply(self.M_w, w) + self.F)
        r = torch.where(self.free[0], r, 0.0)
        dx = lu.solve(r.cpu().numpy())
        return phi - torch.as_tensor(dx, dtype=self.dtype, device=self.device)

    # -- species ------------------------------------------------------------
    def _bicgstab(self, A, dinv, b, x, free):
        """BiCGSTAB under Jacobi from ``x``, to ``_tol`` of |b| or to a
        stall (the float32 control stops at its floor)."""
        tol = _tol(self.dtype) * float(torch.linalg.vector_norm(
            torch.where(free, b, 0.0)))
        r = b - A @ x
        rhat = r.clone()
        p = torch.zeros_like(r)
        v = torch.zeros_like(r)
        rho = alpha = omega = 1.0
        best, best_k = float(torch.linalg.vector_norm(r)), 0
        for k in range(1, 5000):
            if best <= tol or k - best_k > 100:
                break
            rho_new = float(rhat @ r)
            beta = (rho_new / rho) * (alpha / omega)
            p = r + beta * (p - omega * v)
            ph = dinv * p
            v = A @ ph
            alpha = rho_new / float(rhat @ v)
            s = r - alpha * v
            sh = dinv * s
            t = A @ sh
            tt = float(t @ t)
            omega = float(t @ s) / tt if tt > 0 else 0.0
            x = x + alpha * ph + omega * sh
            r = s - omega * t
            rho = rho_new
            n = float(torch.linalg.vector_norm(r))
            if n < 0.5 * best:
                best_k = k
            best = min(best, n)
            if omega == 0.0:
                break
        return x

    def species_step(self, phi, cs):
        """Both species' Alexander-2 stages at the frozen potential
        ``phi``; ``cs`` is (c+, c-)."""
        gphi = torch.einsum("ei,eia->ea", phi[self.tris_t], self.G)
        drift = torch.einsum("ea,eia->ei", gphi, self.G)        # (E, 3)
        drift = (drift * (self.area / 3.0)[:, None])[:, :, None].expand(
            -1, -1, 3)
        out = []
        for comp, z, c0 in ((1, 1.0, cs[0]), (2, -1.0, cs[1])):
            A_el = self.K_d + z * drift
            S_el = self.M_p + (self.dt * ALPHA) * A_el
            vals = self.constrain(self.values(S_el), comp)
            S = self.torch_csr(vals)
            dinv = 1.0 / vals[self.diag_slot]
            free, g = self.free[comp], self.g[comp]
            m0 = self.apply(self.M_p, c0)
            b1 = torch.where(free, m0, g)
            c1 = self._bicgstab(S, dinv, b1, torch.where(free, c0, g), free)
            b2 = torch.where(free, m0 - (self.dt * (1.0 - ALPHA))
                             * self.apply(A_el, c1), g)
            c2 = self._bicgstab(S, dinv, b2, c1, free)
            out.append(c2)
        return out

    # -- currents ---------------------------------------------------------
    def currents(self, phi, cp, cm):
        """(I+, I-) per surface, (n_surfaces,) each."""
        G = self.G[self.face_tri]                              # (B, 3, 2)
        tri = self.tris_t[self.face_tri]
        gphi = torch.einsum("bi,bia->ba", phi[tri], G)
        res = []
        for c, sign in ((cp, 1.0), (cm, -1.0)):
            cc = 0.5 * c[self.face_v].sum(1)
            gc = torch.einsum("bi,bia->ba", c[tri], G)
            j = -gc + sign * cc[:, None] * gphi
            f = (j * self.face_nw).sum(1)
            res.append(torch.zeros(self.n_surfaces, dtype=self.dtype,
                                   device=self.device).index_add_(
                0, self.face_phys, f))
        return res


def initial_state(case: Case, pb):
    """Phase B: phi = phi_PB, c+- = c0 exp(-+ phi_PB), with each
    component's Dirichlet values."""
    out = []
    for comp, field in ((0, pb), (1, case.c0 * torch.exp(-pb)),
                        (2, case.c0 * torch.exp(pb))):
        out.append(torch.where(case.free[comp], field, case.g[comp]))
    return out


def run(mesh: dict, system: dict, surfaces: list, n_steps: int,
        dtype=torch.float64, device="cpu") -> dict:
    """The reference's run: PB, the presolved start state, ``n_steps``
    steps with the Poisson re-solve every ``potentialUpdateFreq`` and the
    currents every ``outputFreq`` step. Returns host arrays: ``pb``,
    ``state`` (phi, c+, c-) after the last step, ``currents`` [(step, I+,
    I-)], ``pb_iterations``."""
    case = Case(mesh, system, surfaces, dtype, device)
    pb, pb_its = case.solve_pb()
    phi, cp, cm = initial_state(case, pb)
    lu = case.poisson_factor()
    phi = case.poisson(lu, phi, cp, cm)
    currents = []
    for i in range(n_steps):
        cp, cm = case.species_step(phi, (cp, cm))
        if i % int(system["potentialUpdateFreq"]) == 0:
            phi = case.poisson(lu, phi, cp, cm)
        if i % int(system["outputFreq"]) == 0:
            ip, im = case.currents(phi, cp, cm)
            currents.append((i, ip.cpu().numpy().astype(np.float64),
                             im.cpu().numpy().astype(np.float64)))
    host = lambda v: v.cpu().numpy().astype(np.float64)
    return {"pb": host(pb), "state": tuple(host(v) for v in (phi, cp, cm)),
            "currents": currents, "pb_iterations": pb_its}

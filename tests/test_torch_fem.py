"""Element layer of the port against the reference package on the CPU:
geometry tables, assembly, weak forms, boundary flux, scalar contexts and
ion flux agree to 1e-13, relative to each array's largest entry (f64; sums
in another order than XLA's, so a cancelling entry can differ by a few
ulps of the array's scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem import assembly as JA
from pnp_tpu.fem import geometry as JG
from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import pore_without_dna_mesh
from pnp_tpu.operators import boundary as JB
from pnp_tpu.operators import common as JCM
from pnp_tpu.operators import volume as JV
from pnp_tpu.postprocess import ionflux as JI
from pnp_tpu.workloads.common import make_scalar_context as j_context

from pnp_tpu_torch import interop, problems
from pnp_tpu_torch.fem import assembly as TA
from pnp_tpu_torch.fem import geometry as TG
from pnp_tpu_torch.operators import boundary as TB
from pnp_tpu_torch.operators import common as TCM
from pnp_tpu_torch.operators import volume as TV
from pnp_tpu_torch.postprocess import ionflux as TI
from pnp_tpu_torch.workloads.common import make_scalar_context as t_context

from test_torch_host import jax_sysparams

torch.set_num_threads(1)

def close(a, b, rtol=1e-13, atol=None):
    """a == b to ``rtol``, with the absolute floor ``rtol * max|b|``."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    if atol is None:
        atol = rtol * max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def spaces(degree):
    tsys, tspace = problems.pore_case(30, 17, degree)
    return tsys, tspace, jax_sysparams(tsys), JFS(
        pore_without_dna_mesh(30, 17), degree)


@pytest.mark.parametrize("degree,order", [(1, 2), (1, 3), (1, 5), (2, 4),
                                          (3, 6)])
def test_volume_tables(degree, order):
    _, tspace, _, jspace = spaces(degree)
    a, b = JG.build_volume_tables(jspace, order), \
        TG.build_volume_tables(tspace, order)
    for name in ("shape", "gradphi", "qw", "qy", "dofmap"):
        close(getattr(b, name), getattr(a, name), rtol=0, atol=0)
    assert b.dofmap.dtype == torch.int64 and b.num_elements == a.num_elements
    assert interop.volume_tables(a).gradphi.equal(b.gradphi)


@pytest.mark.parametrize("component", [0, 1, 2])
def test_scalar_context_and_boundary_tables(component):
    tsys, tspace, jsys, jspace = spaces(1)
    a = j_context(jsys, jspace, component, 3)
    b = t_context(tsys, tspace, component, 3, device="cpu")
    for name in ("shape", "qw", "qy", "dofmap", "flux", "neumann"):
        close(getattr(b.bt, name), getattr(a.bt, name), rtol=0, atol=0)
    close(interop.boundary_tables(a.bt).qw, b.bt.qw, rtol=0, atol=0)
    close(b.free, a.free, rtol=0, atol=0)
    close(b.dirichlet, a.dirichlet, rtol=0, atol=0)
    close(b.flux_vector, a.flux_vector)
    for cyl in (False, True):
        close(TB.flux_residual_el(b.bt, component, cyl, tsys.pi),
              JB.flux_residual_el(a.bt, component, cyl, jsys.pi))
    r = np.random.RandomState(component).randn(tspace.ndof)
    close(b.constrain(torch.tensor(r)), a.constrain(jnp.asarray(r)))


def _element_blocks(ndof, dofmap, seed):
    rng = np.random.RandomState(seed)
    E, n = dofmap.shape
    return (rng.randn(2, E, n, n), rng.randn(2, ndof),
            rng.rand(2, ndof) > 0.2)


def test_assembly():
    _, tspace, _, jspace = spaces(2)
    dm = jspace.dofmap
    tdm = torch.as_tensor(dm, dtype=torch.int64)
    ndof = tspace.ndof
    A_el, x, free = _element_blocks(ndof, dm, 0)
    T = torch.tensor
    close(TA.gather(T(x[0]), tdm), JA.gather(jnp.asarray(x[0]), dm))
    ye = np.random.RandomState(1).randn(*dm.shape)
    close(TA.scatter_add(T(ye), tdm, ndof), JA.scatter_add(jnp.asarray(ye),
                                                          dm, ndof))
    close(TA.spmv(T(A_el[0]), T(x[0]), tdm, ndof),
          JA.spmv(jnp.asarray(A_el[0]), jnp.asarray(x[0]), dm, ndof))
    close(TA.spmv_batched(T(A_el), T(x), tdm, ndof),
          JA.spmv_batched(jnp.asarray(A_el), jnp.asarray(x), dm, ndof))
    close(TA.make_constrained_operator(T(A_el[0]), tdm, ndof, T(free[0]))(
        T(x[0])), JA.make_constrained_operator(jnp.asarray(A_el[0]), dm, ndof,
                                               jnp.asarray(free[0]))(
        jnp.asarray(x[0])))
    close(TA.make_constrained_operator(T(A_el), tdm, ndof, T(free))(
        T(x)), JA.make_constrained_operator_batched(
        jnp.asarray(A_el), dm, ndof, jnp.asarray(free))(jnp.asarray(x)))
    close(TA.diagonal(T(A_el[1]), tdm, ndof),
          JA.diagonal(jnp.asarray(A_el[1]), dm, ndof))
    close(TA.constrained_diagonal(T(A_el[1]), tdm, ndof, T(free[1])),
          JA.constrained_diagonal(jnp.asarray(A_el[1]), dm, ndof,
                                  jnp.asarray(free[1])))
    close(TA.constrain_residual(T(x[1]), T(free[1])),
          JA.constrain_residual(jnp.asarray(x[1]), jnp.asarray(free[1])))
    close(TA.dense_constrained_matrix(T(A_el[0]), tdm, ndof, T(free[0])),
          JA.dense_constrained_matrix(jnp.asarray(A_el[0]), dm, ndof,
                                      jnp.asarray(free[0])))
    close(TA.dense_constrained_matrix_batched(T(A_el), tdm, ndof, T(free)),
          JA.dense_constrained_matrix_batched(jnp.asarray(A_el), dm, ndof,
                                              jnp.asarray(free)))


@pytest.mark.parametrize("cylindrical", [False, True])
@pytest.mark.parametrize("degree", [1, 2])
def test_volume_forms(cylindrical, degree):
    tsys, tspace, jsys, jspace = spaces(degree)
    jt = JG.build_volume_tables(jspace, 3)
    tt = TG.build_volume_tables(tspace, 3)
    rng = np.random.RandomState(degree)
    u, cp, cm, phi = (rng.uniform(-1, 1, tspace.ndof) for _ in range(4))
    J = lambda v: jnp.asarray(v)[jt.dofmap]
    T = lambda v: torch.tensor(v)[tt.dofmap]
    pi, l_b, c0 = tsys.pi, 0.7, 0.06
    close(TCM.qfactor(tt, cylindrical, pi), JCM.qfactor(jt, cylindrical, pi))
    close(TCM.interp(T(u), tt.shape), JCM.interp(J(u), jt.shape))
    gj = JCM.interp_grad(J(phi), jt.gradphi)
    gt = TCM.interp_grad(T(phi), tt.gradphi)
    close(gt, gj)
    close(TV.pb_residual_el(T(u), tt, l_b, c0, cylindrical, pi),
          JV.pb_residual_el(J(u), jt, l_b, c0, cylindrical, pi))
    close(TV.pb_jacobian_el(T(u), tt, l_b, c0, cylindrical, pi),
          JV.pb_jacobian_el(J(u), jt, l_b, c0, cylindrical, pi))
    close(TV.poisson_residual_el(T(u), T(cp), T(cm), tt, l_b, cylindrical,
                                 pi),
          JV.poisson_residual_el(J(u), J(cp), J(cm), jt, l_b, cylindrical,
                                 pi))
    close(TV.poisson_jacobian_el(tt, cylindrical, pi),
          JV.poisson_jacobian_el(jt, cylindrical, pi))
    close(TV.laplace_residual_el(T(u), tt), JV.laplace_residual_el(J(u), jt))
    close(TV.laplace_jacobian_el(tt), JV.laplace_jacobian_el(jt))
    for z in (+1.0, -1.0):
        close(TV.drift_diffusion_residual_el(T(cp), gt, tt, z, cylindrical,
                                             pi),
              JV.drift_diffusion_residual_el(J(cp), gj, jt, z, cylindrical,
                                             pi))
        close(TV.drift_diffusion_jacobian_el(gt, tt, z, cylindrical, pi),
              JV.drift_diffusion_jacobian_el(gj, jt, z, cylindrical, pi))
    close(TV.mass_residual_el(T(cm), tt, 2.5, cylindrical, pi),
          JV.mass_residual_el(J(cm), jt, 2.5, cylindrical, pi))
    close(TV.mass_jacobian_el(tt, 2.5, cylindrical, pi),
          JV.mass_jacobian_el(jt, 2.5, cylindrical, pi))


@pytest.mark.parametrize("convention", ["reference", "physical"])
def test_ionflux(convention):
    tsys, tspace, jsys, jspace = spaces(1)
    a = JI.build_ionflux_tables(jspace, True, jsys.pi, 6)
    b = TI.build_ionflux_tables(tspace, True, tsys.pi, 6)
    for name in ("shape_c", "grad_c", "normal", "weight", "dofmap",
                 "edge_phys"):
        close(getattr(b, name), getattr(a, name))
    rng = np.random.RandomState(3)
    phi, cp, cm = (rng.uniform(0, 1, tspace.ndof) for _ in range(3))
    ja = JI.calc_ion_flux(a, *(jnp.asarray(v) for v in (phi, cp, cm)),
                          convention=convention)
    tb = TI.calc_ion_flux(b, *(torch.tensor(v) for v in (phi, cp, cm)),
                          convention=convention)
    close(tb[0], ja[0])
    close(tb[1], ja[1])

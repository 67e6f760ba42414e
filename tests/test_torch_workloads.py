"""The port's other workloads (stationary diffusion, monolithic stationary
and explicit instationary PNP), the one-step method, the monolithic PNP
element forms and the small host modules against the reference package on
the CPU: the same seeded numpy inputs through both, each test with its
tolerance and the value it measured."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu import validation as JVAL
from pnp_tpu.fem import constraints as JCON
from pnp_tpu.fem.geometry import build_volume_tables as j_tables
from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import pore_without_dna_mesh as j_pore_mesh
from pnp_tpu.meshio.structured import rect_mesh as j_rect_mesh
from pnp_tpu.operators import pnp as JP
from pnp_tpu.operators import volume as JV
from pnp_tpu.solvers.linear_problem import make_krylov_solver as j_krylov
from pnp_tpu.timestepping import onestep as JOS
from pnp_tpu.timestepping import tableaux as JTAB
from pnp_tpu.utils import analytic as JAN
from pnp_tpu.utils import grid_debug as JGD
from pnp_tpu.workloads import instationary_pnp as JIP
from pnp_tpu.workloads import stationary_diffusion as JSD
from pnp_tpu.workloads import stationary_pnp as JSP

from pnp_tpu_torch import interop, problems, validation as TVAL
from pnp_tpu_torch.fem.geometry import build_volume_tables as t_tables
from pnp_tpu_torch.operators import pnp as TP
from pnp_tpu_torch.operators import volume as TV
from pnp_tpu_torch.solvers.linear_problem import make_krylov_solver as t_krylov
from pnp_tpu_torch.timestepping import onestep as TOS
from pnp_tpu_torch.timestepping import tableaux as TTAB
from pnp_tpu_torch.utils import analytic as TAN
from pnp_tpu_torch.utils import grid_debug as TGD
from pnp_tpu_torch.workloads import instationary_pnp as TIP
from pnp_tpu_torch.workloads import stationary_diffusion as TSD
from pnp_tpu_torch.workloads import stationary_pnp as TSP

from test_torch_host import jax_sysparams

torch.set_num_threads(1)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def one_wall():
    tsys, tspace = problems.one_wall_case(40, 4)
    return tsys, tspace, jax_sysparams(tsys), JFS(j_rect_mesh(40, 4, 5.0, 0.5),
                                                  1)


@pytest.fixture(scope="module")
def pore():
    tsys, tspace = problems.pore_case(30, 17)
    return tsys, tspace, jax_sysparams(tsys), JFS(j_pore_mesh(30, 17), 1)


# ---- operators/pnp.py ---------------------------------------------------------

@pytest.mark.parametrize("degree,cylindrical", [(1, False), (1, True),
                                                (2, True)])
def test_pnp_element_forms(degree, cylindrical):
    """The composite residual, Jacobian and both mass forms on a seeded
    composite element vector: 1e-13 relative to the largest entry
    (measured <= 4e-16), the composite dof map identical."""
    jspace = JFS(j_rect_mesh(6, 5, 2.0, 1.0, y0=0.1), degree)
    vj = j_tables(jspace, 2 * degree + 1)
    vt = interop.volume_tables(vj)
    n = jspace.ndof
    cmap_j = JP.composite_dofmap(vj.dofmap, n)
    cmap_t = TP.composite_dofmap(vt.dofmap, n)
    assert np.array_equal(cmap_t.numpy(), np.asarray(cmap_j))
    u = np.random.RandomState(7).uniform(-1.0, 1.0, 3 * n)
    ue_j, ue_t = jnp.asarray(u)[cmap_j], torch.tensor(u)[cmap_t]
    l_b, tau, pi = 0.7, 0.3, np.pi
    pairs = [
        (TP.pnp_residual_el(ue_t, vt, l_b, cylindrical, pi),
         JP.pnp_residual_el(ue_j, vj, l_b, cylindrical, pi)),
        (TP.pnp_jacobian_el(ue_t, vt, l_b, cylindrical, pi),
         JP.pnp_jacobian_el(ue_j, vj, l_b, cylindrical, pi)),
        (TP.pnp_mass_residual_el(ue_t, vt, tau, cylindrical, pi),
         JP.pnp_mass_residual_el(ue_j, vj, tau, cylindrical, pi)),
        (TP.pnp_mass_jacobian_el(vt, tau, cylindrical, pi),
         JP.pnp_mass_jacobian_el(vj, tau, cylindrical, pi)),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        assert rel(got, want) <= 1e-13, rel(got, want)
    for a, b in zip(TP.split_el(ue_t), JP.split_el(ue_j)):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ---- timestepping/onestep.py ----------------------------------------------------

def _heat(n=12, degree=1):
    """The heat-equation case of tests/test_timestepping.py in both
    packages: unit square, homogeneous Dirichlet, u0 = sin sin."""
    jspace = JFS(j_rect_mesh(n, n, 1.0, 1.0), degree)
    vj = j_tables(jspace, 2 * degree + 1)
    vt = interop.volume_tables(vj)
    free = np.ones(jspace.ndof, dtype=bool)
    free[np.unique(jspace.bedge_dofs)] = False
    x = jspace.dof_coords
    u0 = np.where(free, np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]), 0.0)
    return jspace.ndof, vj, vt, free, u0


TABLEAUX = ["implicit_euler", "alexander2", "fractional_step_theta",
            "one_step_theta", "explicit_euler"]


@pytest.mark.parametrize("name", TABLEAUX)
def test_one_step_method_matches_reference(name):
    """Four steps of the heat equation under each tableau (implicit and
    explicit stages, the history residual) in both packages: the same
    Krylov iterations and 1e-12 (measured <= 8e-16)."""
    ndof, vj, vt, free, u0 = _heat()
    args = (0.5,) if name == "one_step_theta" else ()
    tab_j, tab_t = getattr(JTAB, name)(*args), getattr(TTAB, name)(*args)
    dt = 1e-5 if name == "explicit_euler" else 0.005
    mj = JOS.LinearOneStepMethod(
        tab_j, JV.mass_jacobian_el(vj), JV.laplace_jacobian_el(vj),
        jnp.zeros(ndof), vj.dofmap, ndof, jnp.asarray(free),
        j_krylov("CG_Jacobi", 10000), 1e-12, lambda t: jnp.zeros(ndof))
    mt = TOS.LinearOneStepMethod(
        tab_t, TV.mass_jacobian_el(vt), TV.laplace_jacobian_el(vt),
        torch.zeros(ndof, dtype=torch.float64), vt.dofmap, ndof,
        torch.tensor(free), t_krylov("CG_Jacobi", 10000), 1e-12,
        lambda t: torch.zeros(ndof, dtype=torch.float64))
    uj, ut, t = jnp.asarray(u0), torch.tensor(u0), 0.0
    for _ in range(4):
        uj, kj = mj.apply(t, dt, uj)
        ut, kt = mt.apply(t, dt, ut)
        assert kt == int(kj) > 0
        t += dt
    assert rel(ut, uj) <= 1e-12, rel(ut, uj)


def test_one_step_dirichlet_values_and_cfl():
    """``dirichlet_fn`` is read at every stage time: boundary values that
    grow with t reach the solution as in the reference (1e-12; measured
    6e-16). ``cfl_timestep`` is the same number."""
    ndof, vj, vt, free, _ = _heat(8)
    gj = lambda t: jnp.where(jnp.asarray(free), 0.0, 1.0 + t)
    gt = lambda t: torch.tensor(np.where(free, 0.0, 1.0 + t))
    mj = JOS.LinearOneStepMethod(
        JTAB.alexander2(), JV.mass_jacobian_el(vj), JV.laplace_jacobian_el(vj),
        jnp.zeros(ndof), vj.dofmap, ndof, jnp.asarray(free),
        j_krylov("CG_Jacobi", 10000), 1e-12, gj)
    mt = TOS.LinearOneStepMethod(
        TTAB.alexander2(), TV.mass_jacobian_el(vt), TV.laplace_jacobian_el(vt),
        torch.zeros(ndof, dtype=torch.float64), vt.dofmap, ndof,
        torch.tensor(free), t_krylov("CG_Jacobi", 10000), 1e-12, gt)
    uj, _ = mj.apply(0.2, 0.1, gj(0.2))
    ut, _ = mt.apply(0.2, 0.1, gt(0.2))
    assert rel(ut, uj) <= 1e-12, rel(ut, uj)
    assert np.allclose(ut.numpy()[~free], 1.3)
    assert TOS.cfl_timestep(0.05, 2.0, 0.01) == JOS.cfl_timestep(0.05, 2.0,
                                                                 0.01)


# ---- workloads ----------------------------------------------------------------

@pytest.mark.parametrize("solver,reduction,its_slack,tol", [
    ("CG_Jacobi", 1e-10, 0, 1e-10),
    ("BCGS_SSORk", 1e-10, 0, 1e-9),
    ("BCGS_SSORk", 1e-12, 1, 1e-10),
])
def test_stationary_diffusion_matches_reference(one_wall, solver, reduction,
                                                its_slack, tol, tmp_path):
    """The linear solve and the same two output files. CG at the
    workload's own 1e-10 reduction: the same iterations, the field to
    1e-10 (measured 3.9e-14). Chebyshev-BiCGSTAB amplifies the two
    packages' rounding along its Krylov path: at 1e-10 the iterations are
    equal (25) and the fields differ by 1.06e-10, the size of the solve's
    own tolerance (bound 1e-9); solved to 1e-12 the fields agree to 1e-10
    (measured 4e-14) and the count differs by one (29 against 28)."""
    tsys, tspace, jsys, jspace = one_wall
    tsys = dataclasses.replace(tsys, linearSolver=solver)
    jsys = dataclasses.replace(jsys, linearSolver=solver)
    ut, rt = TSD.run_stationary_diffusion(tsys, tspace, reduction,
                                          device="cpu",
                                          output_dir=str(tmp_path / "t"))
    uj, rj = JSD.run_stationary_diffusion(jsys, jspace, reduction,
                                          output_dir=str(tmp_path / "j"))
    assert abs(rt.iterations - int(rj.iterations)) <= its_slack
    assert rt.iterations > 0
    assert rel(ut, uj) <= tol, rel(ut, uj)
    for name in ("solution.dat.dat", "yeah.vtu"):
        got = (tmp_path / "t" / name).read_text().split()
        want = (tmp_path / "j" / name).read_text().split()
        assert len(got) == len(want) > 0


def test_stationary_diffusion_stiffness_dump_and_amg(one_wall, tmp_path,
                                                     monkeypatch):
    """``printStiffnessMatrix`` dumps the constrained dense matrix (equal
    to the reference's to 1e-13), and ``CG_AMG_SSOR`` runs CG under the
    two-level AMG: the reference's iteration count, the field to 1e-10."""
    tsys, tspace, jsys, jspace = one_wall
    monkeypatch.chdir(tmp_path)
    TSD.run_stationary_diffusion(
        dataclasses.replace(tsys, printStiffnessMatrix=True), tspace,
        device="cpu")
    got = np.load(tmp_path / "stiffness_matrix.npy")
    JSD.run_stationary_diffusion(
        dataclasses.replace(jsys, printStiffnessMatrix=True), jspace)
    want = np.load(tmp_path / "stiffness_matrix.npy")
    assert got.shape == want.shape == (tspace.ndof, tspace.ndof)
    assert rel(got, want) <= 1e-13
    ut, rt = TSD.run_stationary_diffusion(
        dataclasses.replace(tsys, linearSolver="CG_AMG_SSOR"), tspace,
        device="cpu")
    uj, rj = JSD.run_stationary_diffusion(
        dataclasses.replace(jsys, linearSolver="CG_AMG_SSOR"), jspace)
    assert rt.converged and rt.iterations == int(rj.iterations) > 0
    assert rel(ut, uj) <= 1e-10, rel(ut, uj)


@pytest.mark.parametrize("convention", ["bce", "monolithic"])
def test_composite_state_matches_reference(pore, convention):
    """Both bootstrap conventions on a seeded PB field: the port's state
    equals the reference's, carried across by interop, bit for bit."""
    tsys, tspace, jsys, jspace = pore
    pb = np.random.RandomState(2).uniform(-2.0, 2.0, tspace.ndof)
    want = JSP.composite_state(jsys, jspace, jnp.asarray(pb), convention)
    got = TSP.composite_state(tsys, tspace, torch.tensor(pb), convention,
                              device="cpu")
    carried = interop.composite_state(*want)
    for g, w, c in zip(got, want, carried):
        assert g.dtype == c.dtype and tuple(g.shape) == (3 * tspace.ndof,)
        assert torch.equal(g, c)


@pytest.mark.parametrize("from_pb,bootstrap", [(True, "monolithic"),
                                               (True, "bce"),
                                               (False, "monolithic")])
def test_stationary_pnp_matches_reference(one_wall, from_pb, bootstrap):
    """The 3-field Newton solve from PB (both bootstrap conventions) and
    cold: the same Newton iterations, the composite vector to 1e-9
    (measured <= 9.1e-12)."""
    tsys, tspace, jsys, jspace = one_wall
    rt = TSP.run_stationary_pnp(tsys, tspace, from_pb=from_pb,
                                bootstrap=bootstrap, device="cpu")
    rj = JSP.run_stationary_pnp(jsys, jspace, from_pb=from_pb,
                                bootstrap=bootstrap)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations) > 0
    assert rel(rt.u, rj.u) <= 1e-9, rel(rt.u, rj.u)
    for a, b in zip(TSP.split_fields(tspace, rt.u),
                    JSP.split_fields(jspace, rj.u)):
        assert tuple(a.shape) == tuple(b.shape) == (tspace.ndof,)


def test_stationary_pnp_solver_remap_and_reassembly(one_wall):
    """Every variant of the config surface maps to a BiCGSTAB peer
    (``CG_AMG_SSOR`` too: the remap comes before the Krylov factory; from
    PB its PB phase runs CG under the two-level AMG, and the solve matches
    the reference's, 1e-9), and ``newtonReassembleThreshold`` reuses the
    Jacobian as in the reference: the same Jacobian builds, 1e-9."""
    tsys, tspace, jsys, jspace = one_wall
    assert TSP._MONOLITHIC_SOLVER == JSP._MONOLITHIC_SOLVER
    amg = dataclasses.replace(tsys, linearSolver="CG_AMG_SSOR")
    assert TSP.run_stationary_pnp(amg, tspace, from_pb=False,
                                  device="cpu").converged
    rt = TSP.run_stationary_pnp(amg, tspace, from_pb=True, device="cpu")
    rj = JSP.run_stationary_pnp(
        dataclasses.replace(jsys, linearSolver="CG_AMG_SSOR"), jspace,
        from_pb=True)
    assert rt.converged and rt.iterations == int(rj.iterations)
    assert rel(rt.u, rj.u) <= 1e-9, rel(rt.u, rj.u)
    kw = dict(newtonReassembleThreshold=0.5, linearSolver="CG_Jacobi")
    rt = TSP.run_stationary_pnp(dataclasses.replace(tsys, **kw), tspace,
                                from_pb=False, device="cpu")
    rj = JSP.run_stationary_pnp(dataclasses.replace(jsys, **kw), jspace,
                                from_pb=False)
    assert rt.iterations == int(rj.iterations)
    assert rt.jacobian_builds == int(rj.jacobian_builds) < rt.iterations
    assert rel(rt.u, rj.u) <= 1e-9, rel(rt.u, rj.u)


def test_stationary_pnp_stalls_on_the_pore_case_in_both_packages(pore):
    """On the pore case (24.1 bias) the monolithic Newton solve stalls in
    the reference as in the port: with a budget of two Newton iterations,
    each package's Jacobi-preconditioned BiCGSTAB runs both linear solves
    to the config's iteration cap from the same initial defect (1e-12),
    and neither defect falls by a hundredth. The unconverged Krylov
    iterates are not compared: past the cap they are round-off's."""
    tsys, tspace, jsys, jspace = pore
    kw = dict(newtonMaxIterations=2)
    rt = TSP.run_stationary_pnp(dataclasses.replace(tsys, **kw), tspace,
                                from_pb=True, device="cpu")
    rj = JSP.run_stationary_pnp(dataclasses.replace(jsys, **kw), jspace,
                                from_pb=True)
    cap = 2 * tsys.linearSolverIterations
    assert not rt.converged and not bool(rj.converged)
    assert rt.linear_iterations == int(rj.linear_iterations) == cap
    assert abs(rt.initial_defect - float(rj.initial_defect)) \
        <= 1e-12 * rt.initial_defect
    assert rt.defect > 0.99 * rt.initial_defect
    assert float(rj.defect) > 0.99 * float(rj.initial_defect)


def test_instationary_pnp_matches_reference(one_wall):
    """Five explicit steps: the same CFL dt, fields to 1e-10 (measured
    <= 4.7e-15)."""
    tsys, tspace, jsys, jspace = one_wall
    rt = TIP.run_instationary_pnp(tsys, tspace, n_steps=5, device="cpu")
    rj = JIP.run_instationary_pnp(jsys, jspace, n_steps=5)
    assert rt.dt == rj.dt and rt.steps == rj.steps == 5
    assert rt.time == rj.time
    assert TIP.min_edge_length(tspace) == JIP.min_edge_length(jspace)
    for name in ("phi", "cp", "cm"):
        a, b = getattr(rt, name), getattr(rj, name)
        assert rel(a, b) <= 1e-10, (name, rel(a, b))


def test_instationary_pnp_pore_case(pore):
    """The same on the cylindrical pore case (3 steps; 1e-10, measured
    <= 1.8e-15)."""
    tsys, tspace, jsys, jspace = pore
    rt = TIP.run_instationary_pnp(tsys, tspace, n_steps=3, device="cpu")
    rj = JIP.run_instationary_pnp(jsys, jspace, n_steps=3)
    assert rt.dt == rj.dt
    for name in ("phi", "cp", "cm"):
        a, b = getattr(rt, name), getattr(rj, name)
        assert rel(a, b) <= 1e-10, (name, rel(a, b))


# ---- validation.py, utils/ ------------------------------------------------------

def test_validation_matches_reference(pore, tmp_path):
    """L2 norms through the mass matrix (1e-14), golden save and check."""
    tsys, tspace, jsys, jspace = pore
    rng = np.random.RandomState(9)
    u, v = rng.standard_normal((2, tspace.ndof))
    assert abs(TVAL.l2_norm(tspace, u) / JVAL.l2_norm(jspace, u) - 1) <= 1e-14
    assert abs(TVAL.relative_l2(tspace, torch.tensor(u), v)
               / JVAL.relative_l2(jspace, u, v) - 1) <= 1e-13
    path = str(tmp_path / "g" / "golden.npz")
    TVAL.save_golden(path, phi=torch.tensor(u), cp=v)
    errs = TVAL.check_golden(path, tspace, 1e-12, phi=u, cp=v)
    assert errs == JVAL.check_golden(path, jspace, 1e-12, phi=u, cp=v)
    with pytest.raises(AssertionError, match="golden mismatch"):
        TVAL.check_golden(path, tspace, 1e-12, phi=u + 1e-3, cp=v)


def test_small_host_modules_are_copies(pore):
    tsys, tspace, jsys, jspace = pore
    assert TGD.describe_mesh(tspace.mesh) == JGD.describe_mesh(jspace.mesh)
    x = np.random.RandomState(1).standard_normal((7, 2))
    assert np.array_equal(TAN.parabolic_potential(2.5)(x),
                          JAN.parabolic_potential(2.5)(x))
    assert np.array_equal(TAN.zero_force(x), JAN.zero_force(x))

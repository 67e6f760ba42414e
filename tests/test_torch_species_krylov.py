"""The port's species Krylov path against the reference package on the
CPU, on the 488-node pore case: tableaux whose stage diagonals differ
(each stage its own local inverses on the block-RAS tier, the configured
Krylov variant on the batched diagonal elsewhere), every other solver
variant above the dense tier (species stages and the 1e-10 Poisson
re-solve by that variant, with the lambda_max(D^-1 A) estimates of setup),
and the gates that choose between these and the factored paths. The same
PB field goes into both packages; every comparison is made under the
presolved protocol (``poisson_solve`` once, then 3 steps). Each test
states its tolerance and the value it measured.

``fractional_step_theta()`` has three stages but ONE stage diagonal
(alpha theta = beta (1 - 2 theta), bit for bit in both packages), so it
takes the factored paths with three stages to a factor; the tableau with
differing diagonals here is three implicit-Euler substeps of unequal
length."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem import assembly as JA
from pnp_tpu.fem.geometry import build_volume_tables as j_tables
from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import pore_without_dna_mesh
from pnp_tpu.operators import volume as JV
from pnp_tpu.operators.common import interp_grad as j_interp_grad
from pnp_tpu.postprocess.ionflux import calc_ion_flux as j_ion_flux
from pnp_tpu.solvers.precond import estimate_dinv_spectral_radius as j_lam
from pnp_tpu.timestepping import tableaux as JTAB
from pnp_tpu.workloads import instationary_pnp_from_pb as JW
from pnp_tpu.workloads.common import make_scalar_context as j_context

from pnp_tpu_torch import interop, problems
from pnp_tpu_torch.postprocess.ionflux import calc_ion_flux
from pnp_tpu_torch.timestepping import tableaux as TTAB
from pnp_tpu_torch.workloads import instationary_pnp_from_pb as TW

from test_torch_host import jax_sysparams

torch.set_num_threads(1)

RAS = dict(dense_poisson_threshold=0, ras_block_size=64)
STAGE_SLACK = 2e-4     # the reference's stage-tolerance bound (test_block_ras.py:190)
STEPS = 3


def substeps(module):
    """``problems.substeps_tableau`` (three implicit-Euler substeps of
    lengths 0.2, 0.3, 0.5: stage diagonals that differ) as ``module``'s
    Tableau."""
    t = problems.substeps_tableau()
    return module.Tableau(t.name, A=t.A, B=t.B, D=t.D, implicit=t.implicit)


TABLEAUX = {
    "fractional_step_theta": lambda m: m.fractional_step_theta(),
    "substeps": substeps,
    "alexander2": lambda m: m.alexander2(),
}


def slack(a, b) -> float:
    """max |a - b| / (max |b| + 1), the reference's cross-tier measure."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1.0))


@pytest.fixture(scope="module")
def case():
    tsys, tspace = problems.pore_case(30, 17)
    jspace = JFS(pore_without_dna_mesh(30, 17), 1)
    pb = JW.build_pnp_system(jax_sysparams(tsys), jspace).pb
    return dict(tsys=tsys, tspace=tspace, jspace=jspace, pb=pb)


def build_pair(case, tableau, solver="BCGS_SSORk", **kw):
    """The same configuration in both packages, on the same PB field."""
    tsys = dataclasses.replace(case["tsys"], linearSolver=solver)
    j = JW.build_pnp_system(jax_sysparams(tsys), case["jspace"],
                            tableau=TABLEAUX[tableau](JTAB),
                            pb_field=case["pb"], **kw)
    t = TW.build_pnp_system(tsys, case["tspace"],
                            tableau=TABLEAUX[tableau](TTAB),
                            pb_field=interop.field(case["pb"]), device="cpu",
                            **kw)
    return j, t


def presolved_steps(system, ion_flux, to_int=int):
    """``poisson_solve`` once, then STEPS of species stages and Poisson
    re-solve: the final state, the currents after every step and the
    (species, Poisson) counts of every step."""
    s = (system.uphi0, system.ucp0, system.ucm0)
    uphi, _ = system.poisson_solve(*s)
    s = (uphi, s[1], s[2])
    currents, counts = [], []
    for _ in range(STEPS):
        cp, cm, k = system.species_step(*s)
        uphi, kp = system.poisson_solve(s[0], cp, cm)
        s = (uphi, cp, cm)
        ip, im = ion_flux(system.ionflux_tables, *s)
        currents.append(np.concatenate([np.asarray(ip), np.asarray(im)]))
        counts.append((to_int(k), to_int(kp)))
    return s, np.stack(currents), counts


def compare(j, t, poisson_counts_within=lambda kp: 1):
    """Fields and currents within the stage slack; species counts within
    one, Poisson counts within ``poisson_counts_within(count)``. Returns
    what was measured."""
    sj, cur_j, counts_j = presolved_steps(j, j_ion_flux)
    st, cur_t, counts_t = presolved_steps(t, calc_ion_flux)
    worst = max(slack(b.numpy(), a) for a, b in zip(sj, st))
    worst_cur = slack(cur_t, cur_j)
    assert all(bool(torch.isfinite(v).all()) for v in st)
    assert worst <= STAGE_SLACK and worst_cur <= STAGE_SLACK, (worst,
                                                               worst_cur)
    for (kj, pj), (kt, pt) in zip(counts_j, counts_t):
        assert abs(kj - kt) <= 1, (counts_j, counts_t)
        assert abs(pj - pt) <= poisson_counts_within(pj), (counts_j, counts_t)
    return worst, worst_cur, counts_t


# --- (a) the dense tier -----------------------------------------------------

def test_dense_tier_fractional_step_theta(case):
    """Three stages, one stage diagonal: the dense factored path, one f32
    stage inverse a step serving all three stages. Fields and currents
    within 2e-4 (measured 4e-15 and 2e-15), the same refinement counts (6 a
    step)."""
    j, t = build_pair(case, "fractional_step_theta")
    assert (t.factor_kind, t.poisson_tier) == ("dense", "dense")
    assert t.species_factor is not None and t.lam_species is None
    worst, worst_cur, _ = compare(j, t)
    assert worst <= 1e-10 and worst_cur <= 1e-10


def test_dense_tier_differing_stage_diagonals(case):
    """No factor serves every stage: BiCGSTAB + Chebyshev-Jacobi on each
    stage's batched diagonal with ``lam_species``, the Poisson re-solve
    still the dense affine form. Measured: fields 3e-15, currents 2e-15,
    14-16 iterations a step in both packages."""
    j, t = build_pair(case, "substeps")
    assert (t.factor_kind, t.poisson_tier) == (None, "dense")
    assert t.species_factor is t.species_step_reuse is None
    assert t.fused_step_reuse is None and t.species_dense_f32 is None
    assert j.species_factor is None and j.factor_kind is None
    worst, worst_cur, counts = compare(j, t)
    assert worst <= 1e-10 and worst_cur <= 1e-10
    assert all(1 < k < 100 and kp == 1 for k, kp in counts)


# --- (b) the block-RAS tier, forced on the small case -------------------------

@pytest.mark.parametrize("two_level", [False, True],
                         ids=["one-level", "two-level"])
@pytest.mark.parametrize("tableau", ["fractional_step_theta", "substeps"])
def test_block_ras_tier(case, tableau, two_level, monkeypatch):
    """``fractional_step_theta``: one RAS factor a step (with the p1 coarse
    level when ``species_two_level``) serves its three stages.
    ``substeps``: every stage builds its own local inverses, one-level
    (the reference hands the coarse level over only with a factor), three
    builds a step. Fields and currents within 2e-4 (measured 3e-12 and
    2e-11; 6 iterations a step in every case);
    species counts within one, the mid-size Poisson refinements within
    one (2 or 3 passes, as on the factored path)."""
    builds = []
    real = TW.BR.build_local_inverses
    monkeypatch.setattr(
        TW.BR, "build_local_inverses",
        lambda ctx, A_el, free: builds.append(tuple(A_el.shape))
        or real(ctx, A_el, free))
    j, t = build_pair(case, tableau, species_two_level=two_level, **RAS)
    uniform = tableau == "fractional_step_theta"
    assert t.poisson_tier == "inverse"
    assert t.factor_kind == ("ras" if uniform else None)
    assert (t.species_factor is None) == (not uniform)
    assert (j.species_factor is None) == (not uniform)
    builds.clear()
    worst, worst_cur, counts = compare(j, t)
    E = case["tspace"].mesh.num_tris
    # (2, E, 3, 3) stage batches: one a step, or one a stage
    assert builds == [(2, E, 3, 3)] * (STEPS * (1 if uniform else 3))
    assert worst <= 1e-9 and worst_cur <= 1e-9
    assert all(1 < k < 40 for k, _ in counts)


# --- (c) the other solver variants above the dense tier -----------------------

@pytest.mark.parametrize("solver", ["BCGS_NOPREC", "BCGS_Jacobi", "CG_Jacobi",
                                    "CG_NOPREC"])
def test_solver_variants_above_dense_tier(case, solver):
    """Alexander-2 (where every variant converges in the reference: CG on
    the drift-diffusion stages included, 10-31 iterations a step), species
    stages and the 1e-10 Poisson re-solve by the variant itself. Fields
    and currents within 2e-4 (measured: fields 3e-9 and currents 6e-10 for
    BCGS_NOPREC, <= 8e-12 for the others). Species counts equal; the Poisson counts, 87 to 264
    iterations of an unpreconditioned or diagonally preconditioned solve
    to 1e-10, differ by up to 5 of ~200 (BiCGSTAB's residual is not
    monotone, and the two packages sum in another order): within a
    tenth."""
    j, t = build_pair(case, "alexander2", solver=solver, **RAS)
    assert (t.factor_kind, t.poisson_tier) == (None, "krylov")
    assert t.block_context is None and t.species_local_f32 is None
    worst, worst_cur, counts = compare(
        j, t, poisson_counts_within=lambda kp: 0.1 * kp)
    assert worst <= 1e-7 and worst_cur <= 1e-7
    cap = case["tsys"].linearSolverIterations
    assert all(k < 100 and 10 < kp < cap for k, kp in counts)


# --- the spectral-radius estimates --------------------------------------------

def reference_estimates(case, a01, b01):
    """``lam_phi`` and ``lam_species`` as the reference's setup program
    computes them (workloads/instationary_pnp_from_pb.py:292-331)."""
    jsys, jspace = jax_sysparams(case["tsys"]), case["jspace"]
    ndof = jspace.ndof
    base = JW.build_pnp_system(jsys, jspace, pb_field=case["pb"])
    ctx = j_context(jsys, jspace, component=0, quad_order=3)
    probe = jnp.sin(jnp.arange(ndof) * 0.7) + 1.1
    A_phi = JV.poisson_jacobian_el(ctx.vt, jsys.cylindrical, jsys.pi)
    l_phi = j_lam(
        JA.make_constrained_operator(A_phi, ctx.vt.dofmap, ndof, ctx.free),
        JA.constrained_diagonal(A_phi, ctx.vt.dofmap, ndof, ctx.free), probe)
    from pnp_tpu.fem import constraints as JC
    free_cp = jnp.asarray(JC.free_dof_mask(jspace, jsys, 1))
    vt2, vt5 = j_tables(jspace, 2), j_tables(jspace, 5)
    M = JV.mass_jacobian_el(vt5, 1.0, False, jsys.pi)
    K0 = JV.drift_diffusion_jacobian_el(
        j_interp_grad(base.uphi0[vt2.dofmap], vt2.gradphi), vt2, 1.0, False,
        jsys.pi)
    A0 = a01 * M + (jsys.tau * b01) * K0
    l_sp = j_lam(JA.make_constrained_operator(A0, vt2.dofmap, ndof, free_cp),
                 JA.constrained_diagonal(A0, vt2.dofmap, ndof, free_cp),
                 probe)
    return 1.2 * float(l_phi), 1.2 * float(l_sp)


def test_spectral_radius_estimates(case):
    """``lam_phi`` and ``lam_species`` (12 power iterations from the same
    probe, 1.2 headroom) to 1e-10 relative (measured 1e-15), and present
    only where a Krylov path reads them."""
    tab = TTAB.alexander2()
    want_phi, want_sp = reference_estimates(case, float(tab.A[0][1]),
                                            float(tab.B[0][1]))
    _, t = build_pair(case, "alexander2", solver="BCGS_Jacobi", **RAS)
    assert abs(float(t.lam_phi) - want_phi) <= 1e-10 * want_phi
    assert abs(float(t.lam_species) - want_sp) <= 1e-10 * want_sp
    assert 1.0 < float(t.lam_phi) < 4.0 and 1.0 < float(t.lam_species) < 4.0
    t_ras = TW.build_pnp_system(case["tsys"], case["tspace"],
                                pb_field=interop.field(case["pb"]),
                                device="cpu", **RAS)
    assert t_ras.lam_phi is None and t_ras.lam_species is None


# --- the gates and the run loop -----------------------------------------------

def test_run_loop_takes_the_krylov_path(case, tmp_path):
    """``run_instationary_pnp_from_pb`` with differing stage diagonals on
    the forced block-RAS tier: no factor to reuse, so every step is a
    fresh one (three local-inverse builds), and the run equals stepping
    the system by hand, bit for bit on the CPU."""
    run = TW.run_instationary_pnp_from_pb(
        case["tsys"], case["tspace"], n_steps=STEPS, tableau=substeps(TTAB),
        presolve_potential=True, output_dir=str(tmp_path), device="cpu",
        **RAS)
    assert run.system.factor_kind is None
    assert run.factor_rebuilt == [True] * STEPS
    t = TW.build_pnp_system(case["tsys"], case["tspace"],
                            tableau=substeps(TTAB),
                            pb_field=run.system.pb, device="cpu", **RAS)
    st, cur, counts = presolved_steps(t, calc_ion_flux)
    assert run.species_iterations == [k for k, _ in counts]
    for a, b in zip((run.phi, run.cp, run.cm), st):
        # the run ends with one more Poisson solve: phi within its 1e-10
        assert slack(a.numpy(), b.numpy()) <= 1e-9
    _, ip, im = run.current_history[-1]
    assert slack(np.concatenate([ip, im]), cur[-1]) <= 1e-12
    rows = (tmp_path / "current.dat").read_text().strip().split("\n")
    assert len(rows) == STEPS


def test_gates_that_stay_closed(case):
    """``CG_AMG_SSOR`` above the dense tier: CG under the two-level AMG on
    both Krylov paths (one aggregation for phi, one over the species
    masks' union), held to the reference like the other variants. On
    element-sharded tables this variant needs a shard count that divides
    the element count, as in the reference: 8 shards of this case's 852
    triangles raise ValueError.
    The mid-size species inverse tier is a block-RAS option: with another
    solver variant it changes nothing, as in the reference. An unknown
    variant is a ValueError, as in the reference."""
    tsys, tspace = case["tsys"], case["tspace"]
    pb = interop.field(case["pb"])
    j, t = build_pair(case, "alexander2", solver="CG_AMG_SSOR", **RAS)
    assert (t.factor_kind, t.poisson_tier) == (None, "krylov")
    worst, worst_cur, counts = compare(
        j, t, poisson_counts_within=lambda kp: 0.1 * kp)
    # measured 7.1e-16 and 8.1e-16 (1.2e-8 and 2.9e-8 before the coarse
    # factor took the symmetric part of A_c, as jnp.linalg.cholesky does)
    assert worst <= 1e-12 and worst_cur <= 1e-12
    assert all(0 < k < 100 and 0 < kp < tsys.linearSolverIterations
               for k, kp in counts)
    jacobi = dataclasses.replace(tsys, linearSolver="BCGS_Jacobi")
    system = TW.build_pnp_system(jacobi, tspace, pb_field=pb,
                                 species_inv_threshold=1000,
                                 dense_poisson_threshold=0, device="cpu")
    assert system.factor_kind is None and system.species_factor is None
    with pytest.raises(ValueError, match="divides the element count"):
        TW.build_pnp_system(
            dataclasses.replace(tsys, linearSolver="CG_AMG_SSOR"), tspace,
            pb_field=pb, device_mesh=8, device="cpu")
    with pytest.raises(ValueError):
        TW.build_pnp_system(dataclasses.replace(tsys, linearSolver="GMRES"),
                            tspace, pb_field=pb, device="cpu")

"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Imports no jax, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Everything here is marked ``cuda`` and skips without a CUDA device."""

import numpy as np
import pytest
import torch

from pnp_tpu_torch.fem.geometry import build_volume_tables
from pnp_tpu_torch.fem.space import FunctionSpace
from pnp_tpu_torch.meshio.structured import rect_mesh
from pnp_tpu_torch.operators import kernels as K
from pnp_tpu_torch.problems import pore_case, substeps_tableau
from pnp_tpu_torch.solvers.direct import contraction_ok
from pnp_tpu_torch.tools.spmv_sweep import case_tensors
from pnp_tpu_torch.workloads.common import make_scalar_context
from pnp_tpu_torch.workloads.instationary_pnp_from_pb import (
    build_pnp_system, run_instationary_pnp_from_pb)
from pnp_tpu_torch.workloads.pb import solve_pb

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def well_conditioned(S, N):
    rng = np.random.RandomState(0)
    return (rng.rand(S, N, N).astype(np.float32) * 0.1
            + np.eye(N, dtype=np.float32)[None] * N * 0.05)


def permuted(N=256):
    rng = np.random.RandomState(1)
    A0 = (np.eye(N, dtype=np.float32) * 8
          + rng.standard_normal((N, N)).astype(np.float32))
    P = np.eye(N, dtype=np.float32)[rng.permutation(N)]
    return (P @ A0).astype(np.float32)[None]


# kernel 1 against its plain version: the same panel-blocked elimination,
# sums rounded in another order (fused multiply-adds; cuBLAS sums otherwise),
# times the matrix's conditioning: 1e-4 of the inverse's scale, the bound
# chip_smoke.py holds it to (measured there: under 2e-7 on the
# well-conditioned cases)
GJ_REL_TOL = 1e-4

#: the kernels every step of the production workload launches (the CG
#: kernels run only where a solve is CG)
STEP_KERNELS = ("gj_inverse", "pb_residual_jacobian", "element_spmv")


@pytest.mark.parametrize("case", ["2x128", "2x300", "1x40", "2x1000",
                                  "permuted"])
def test_gj_kernel_matches_plain(cuda, case):
    """Both variants on and off the panel grid (2x300: the one-block
    kernel, nine 32-wide panels and a ragged one; 2x1000: the panel path,
    fifteen 64-wide panels and a ragged one): within GJ_REL_TOL of the
    plain version; the contraction probe passes."""
    if case == "permuted":
        A = torch.tensor(permuted(), device=cuda)
    else:
        S, N = map(int, case.split("x"))
        A = torch.tensor(well_conditioned(S, N), device=cuda)
    n0 = K.launches["gj_inverse"]
    X = K.gj_inverse(A)
    assert K.launches["gj_inverse"] == n0 + 1
    Xp = K.gj_inverse_plain(A)
    torch.testing.assert_close(X, Xp, rtol=0,
                               atol=GJ_REL_TOL * float(Xp.abs().max()))
    assert contraction_ok(A, X)


@pytest.mark.parametrize("S,N,panel,variant,reverse", [
    (2, 20, 32, 0, False), (2, 20, 64, 1, False),      # N below one panel
    (3, 333, 32, 0, False), (1, 515, 48, 1, False),    # ragged last panel
    (2, 300, 32, 0, True), (1, 700, 64, 1, True),      # cross-block pivots
    (1, 515, 48, 2, False), (1, 700, 64, 2, True),
    (2, 3105, 64, 2, False),                           # the dense stage batch
])
def test_gj_kernel_variants_pivot_like_plain(cuda, S, N, panel, variant,
                                             reverse):
    """Each kernel variant (0: one block a matrix, 1: the panel path, a
    launch a column, 2: the panel path, a cluster launch a panel) picks
    the plain version's pivot rows and agrees with it within GJ_REL_TOL;
    with the rows reversed every early pivot comes from the last rows.
    Variant 2 gives variant 1's inverse and pivot rows bit for bit."""
    A = well_conditioned(S, N)
    A = torch.tensor(A[:, ::-1].copy() if reverse else A, device=cuda)
    X, pivots = K._gj_core_cuda(A, panel, variant)
    Xp, pivots_p = K._gj_core_plain(A, panel)
    assert torch.equal(pivots.long(), pivots_p)
    assert not reverse or int(pivots[0, 0]) == N - 1
    torch.testing.assert_close(X, Xp, rtol=0,
                               atol=GJ_REL_TOL * float(Xp.abs().max()))
    assert contraction_ok(A, X)
    if variant == 2:
        X1, pivots_1 = K._gj_core_cuda(A, panel, 1)
        assert torch.equal(X, X1) and torch.equal(pivots, pivots_1)


@pytest.mark.parametrize("S,N", [(2, 3105), (8, 1685)])
def test_gj_cluster_panel_equals_column_panel(cuda, S, N):
    """At the dense stage batch of the L0 cell and the Schwarz batch, on
    the equilibrated matrices the wrapper hands its core: the cluster
    panel (the plan's cluster) and the per-column launches give the same
    inverse and pivot rows, bit for bit; the first has the wrapper's
    path."""
    A = torch.tensor(well_conditioned(S, N), device=cuda)
    s = torch.rsqrt(torch.diagonal(A, dim1=1, dim2=2).abs())
    W = A * s[:, :, None] * s[:, None, :]
    assert K.gj_variant(K._library(), S, N) == 2
    X2, p2 = K._gj_core_cuda(W, variant=2)
    X1, p1 = K._gj_core_cuda(W, variant=1)
    assert torch.equal(p2, p1)
    assert torch.equal(X2, X1)


def test_gj_chooser_takes_the_cluster_panel_where_it_holds(cuda):
    """Through the plan alone (nothing allocated): the one-block kernel up
    to SMALL_N_MAX, the cluster panel at 3,105 and 4,801 nodes, a launch a
    column where no cluster holds the panel (12,097, and the L2 set-up's
    47,745)."""
    lib = K._library()
    assert K.gj_variant(lib, 1484, 374) == 0
    assert K.gj_variant(lib, 2, 3105) == 2
    assert K.gj_variant(lib, 2, 4801) == 2
    assert K.gj_variant(lib, 1, 12097) == 1
    assert K.gj_variant(lib, 1, 47745) == 1


def test_gj_paths_count_each_call_once(cuda):
    """``kernels.gj_paths`` adds one a launched call, to its path, beside
    ``launches["gj_inverse"]``; a CPU call counts nowhere."""
    K.reset_launch_counts()
    K.gj_inverse(torch.tensor(well_conditioned(2, 300), device=cuda))
    K.gj_inverse(torch.tensor(well_conditioned(1, 600), device=cuda))
    K.gj_inverse(torch.tensor(well_conditioned(1, 600), device=cuda))
    K._gj_core_cuda(torch.tensor(well_conditioned(1, 600), device=cuda),
                    variant=1)
    K.gj_inverse(torch.tensor(well_conditioned(1, 40)))
    assert K.gj_paths == {"one_block": 1, "cluster_panel": 2,
                          "column_panel": 1}
    assert K.launches["gj_inverse"] == 4


def test_entry_points_default_to_the_card(cuda):
    """Without ``device`` every entry point lands on the current CUDA
    device."""
    sys_, space = pore_case(12, 7)
    outs = (make_scalar_context(sys_, space, component=0,
                                quad_order=3).dirichlet,
            solve_pb(sys_, space).u, build_pnp_system(sys_, space).pb,
            run_instationary_pnp_from_pb(sys_, space, n_steps=1).phi)
    for t in outs:
        assert t.is_cuda and t.device.index == torch.cuda.current_device()


def pb_args(cuda, degree, cylindrical, dtype=torch.float64):
    space = FunctionSpace(rect_mesh(20, 16, 2.0, 1.0, y0=0.1), degree)
    vt = build_volume_tables(space, max(3, 2 * degree), cuda)
    g = torch.Generator().manual_seed(degree)
    u = (torch.rand(space.ndof, generator=g, dtype=torch.float64) * 2 - 1)
    return tuple(t.to(dtype) for t in (u.to(cuda)[vt.dofmap], vt.shape,
                                       vt.gradphi, vt.qw, vt.qy)) + (
        1.0, 0.06, cylindrical, np.pi)


@pytest.mark.parametrize("cylindrical", [False, True])
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_pb_kernel_matches_plain(cuda, cylindrical, degree):
    """f64, sums in another order: 1e-13 of each output's scale."""
    args = pb_args(cuda, degree, cylindrical)
    n0 = K.launches["pb_residual_jacobian"]
    r, A = K.pb_residual_jacobian(*args)
    assert K.launches["pb_residual_jacobian"] == n0 + 1
    r_p, A_p = K.pb_residual_jacobian_plain(*args)
    for a, b in ((r, r_p), (A, A_p)):
        torch.testing.assert_close(a, b, rtol=1e-13,
                                   atol=1e-13 * float(b.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("outputs", ["residual", "jacobian"])
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_pb_kernel_one_output_variants(cuda, degree, outputs, dtype):
    """A prepared ``PBElement`` asked for one output launches the variant
    that writes that output alone, equal to the plain version's (f64
    1e-13, f32 1e-5 of its scale), and returns ``None`` for the other."""
    args = pb_args(cuda, degree, True, dtype)
    plan = K.PBElement(*args[1:])
    n0 = K.launches["pb_residual_jacobian"]
    got = plan(args[0], outputs)
    assert K.launches["pb_residual_jacobian"] == n0 + 1
    want = K.pb_residual_jacobian_plain(*args, outputs=outputs)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            torch.testing.assert_close(a, b, rtol=tol,
                                       atol=tol * float(b.abs().max()))
    with pytest.raises(ValueError):
        plan(args[0][:-1], outputs)
    with pytest.raises(ValueError):
        plan(args[0].cpu(), outputs)


def test_pb_kernel_one_exp_holds_over_u(cuda):
    """sinh and cosh from one expm1 on the card: |u| from 1e-8 to 20, both
    signs and 0, against torch's sinh and cosh through the volume forms,
    1e-13 relative entry by entry (the sinh and cosh terms alone)."""
    from pnp_tpu_torch.fem.geometry import VolumeTables
    from pnp_tpu_torch.operators import volume as V

    mags = torch.cat([torch.zeros(1, dtype=torch.float64),
                      torch.logspace(-8, np.log10(20.0), 149,
                                     dtype=torch.float64)])
    u = torch.cat([mags, -mags]).to(cuda)
    E, n, q = u.numel(), 3, 4
    g = torch.Generator().manual_seed(7)
    shape = torch.full((q, n), 1.0 / n, dtype=torch.float64, device=cuda)
    gradphi = torch.zeros((E, q, n, 2), dtype=torch.float64, device=cuda)
    qw = (torch.rand((E, q), generator=g, dtype=torch.float64) * 0.04
          + 0.01).to(cuda)
    qy = (torch.rand((E, q), generator=g, dtype=torch.float64) + 0.1).to(cuda)
    ue = u[:, None].repeat(1, n)
    params = (0.7, 0.06, True, np.pi)
    r, A = K.pb_residual_jacobian(ue, shape, gradphi, qw, qy, *params)
    t = VolumeTables(shape=shape, gradphi=gradphi, qw=qw, qy=qy, dofmap=None)
    torch.testing.assert_close(r, V.pb_residual_el(ue, t, *params),
                               rtol=1e-13, atol=0)
    torch.testing.assert_close(A, V.pb_jacobian_el(ue, t, *params),
                               rtol=1e-13, atol=0)


def test_slice_on_card_matches_cpu(cuda):
    """One presolved step of the slice on the card against the CPU plain
    path, to 1e-9 relative (CUDA scatters sum with atomics in a varying
    order; kernels and cuBLAS sum in another order)."""
    sys_, space = pore_case(30, 17)
    K.reset_launch_counts()
    a = run_instationary_pnp_from_pb(sys_, space, n_steps=1,
                                     presolve_potential=True, device=cuda)
    assert min(K.launches[k] for k in STEP_KERNELS) > 0
    b = run_instationary_pnp_from_pb(sys_, space, n_steps=1,
                                     presolve_potential=True, device="cpu")
    for name in ("phi", "cp", "cm"):
        x, y = getattr(a, name).cpu(), getattr(b, name)
        assert float((x - y).abs().max()) <= 1e-9 * float(y.abs().max())


BLOCK_RAS = dict(dense_poisson_threshold=0, ras_block_size=64)


def test_gj_kernel_on_ras_batch(cuda):
    """Kernel 1 on a real species block-RAS batch: the (2, 8, 103, 103)
    local stage matrices of the 488-node pore at the presolved potential,
    flattened to (16, 103, 103). One input tensor for both versions (the
    local assembly sums with atomics on the card); within GJ_REL_TOL, and
    the probe passes."""
    sys_, space = pore_case(30, 17)
    system = build_pnp_system(sys_, space, device=cuda, **BLOCK_RAS)
    uphi, _ = system.poisson_solve(system.uphi0, system.ucp0, system.ucm0)
    A = system.species_local_f32(uphi)
    assert tuple(A.shape) == (2, 8, 103, 103)
    A = A.reshape(16, 103, 103)
    X = K.gj_inverse(A)
    Xp = K.gj_inverse_plain(A)
    torch.testing.assert_close(X, Xp, rtol=0,
                               atol=GJ_REL_TOL * float(Xp.abs().max()))
    assert contraction_ok(A, X)


@pytest.mark.parametrize("poisson_inv_threshold", [49152, 0])
def test_block_ras_step_on_card_matches_cpu(cuda, poisson_inv_threshold):
    """One presolved block-RAS step (mid-size Poisson inverse, or
    two-level RAS Poisson) on the card against the CPU: Krylov iteration
    and refinement counts within one (the card's atomic assembly moves the
    f32 factors' inputs by their last bits, which can move a residual that
    lands on its target across it; chip_smoke.py measured one such step
    in five), fields to 1e-9 relative (the tolerance of the dense-tier
    check above, for the same reasons)."""
    sys_, space = pore_case(30, 17)
    kw = dict(n_steps=1, presolve_potential=True,
              poisson_inv_threshold=poisson_inv_threshold, **BLOCK_RAS)
    K.reset_launch_counts()
    a = run_instationary_pnp_from_pb(sys_, space, device=cuda, **kw)
    assert min(K.launches[k] for k in STEP_KERNELS) > 0
    assert K.launches["krylov_unconverged"] > 0
    b = run_instationary_pnp_from_pb(sys_, space, device="cpu", **kw)
    assert a.system.factor_kind == b.system.factor_kind == "ras"
    for x, y in ((a.species_iterations, b.species_iterations),
                 (a.poisson_iterations, b.poisson_iterations)):
        assert len(x) == len(y) == 1 and abs(x[0] - y[0]) <= 1, (x, y)
    for name in ("phi", "cp", "cm"):
        x, y = getattr(a, name).cpu(), getattr(b, name)
        assert float((x - y).abs().max()) <= 1e-9 * float(y.abs().max())


def test_species_krylov_step_on_card_matches_cpu(cuda):
    """The species Krylov path on the forced block-RAS tier: two presolved
    steps with differing stage diagonals, every stage its own local
    inverses, so kernel 1 launches three times a step (beside the Poisson
    inverse's one). On the card against the CPU: counts within one, fields
    to 1e-9 relative, as the factored block-RAS step above."""
    sys_, space = pore_case(30, 17)
    kw = dict(n_steps=2, presolve_potential=True, tableau=substeps_tableau(),
              **BLOCK_RAS)
    K.reset_launch_counts()
    a = run_instationary_pnp_from_pb(sys_, space, device=cuda, **kw)
    assert K.launches["gj_inverse"] == 1 + 3 * 2
    b = run_instationary_pnp_from_pb(sys_, space, device="cpu", **kw)
    assert a.system.factor_kind is b.system.factor_kind is None
    assert a.system.species_factor is None
    for x, y in ((a.species_iterations, b.species_iterations),
                 (a.poisson_iterations, b.poisson_iterations)):
        assert len(x) == len(y) == 2
        assert max(abs(p - q) for p, q in zip(x, y)) <= 1, (x, y)
    for name in ("phi", "cp", "cm"):
        x, y = getattr(a, name).cpu(), getattr(b, name)
        assert float((x - y).abs().max()) <= 1e-9 * float(y.abs().max())


@pytest.mark.parametrize("solver", ["BCGS_Jacobi", "CG_NOPREC"])
def test_solver_variant_above_dense_tier_on_card(cuda, solver):
    """Another solver variant above the dense tier: species stages and the
    1e-10 Poisson re-solve by the variant itself, on the card against the
    CPU. No kernel 1 on this path. Fields to 1e-8 relative: 90-260 Krylov
    iterations to 1e-10 sum in another order on the card."""
    import dataclasses

    sys_, space = pore_case(30, 17)
    sys_ = dataclasses.replace(sys_, linearSolver=solver)
    kw = dict(n_steps=1, presolve_potential=True, **BLOCK_RAS)
    K.reset_launch_counts()
    a = run_instationary_pnp_from_pb(sys_, space, device=cuda, **kw)
    assert K.launches["gj_inverse"] == 0
    b = run_instationary_pnp_from_pb(sys_, space, device="cpu", **kw)
    assert a.system.poisson_tier == b.system.poisson_tier == "krylov"
    assert abs(a.species_iterations[0] - b.species_iterations[0]) <= 1
    for name in ("phi", "cp", "cm"):
        x, y = getattr(a, name).cpu(), getattr(b, name)
        assert float((x - y).abs().max()) <= 1e-8 * float(y.abs().max())


def _fields_close(a, b, tol):
    for name in ("phi", "cp", "cm"):
        x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
        assert float((x - y).abs().max()) <= tol * float(y.abs().max()), name


def test_very_large_poisson_tier_on_card_matches_cpu(cuda, monkeypatch):
    """The very-large Poisson tier forced at 488 nodes (the mid-size bound
    set to 0): the equilibrated (X_eq, s) inverse by kernel 1 without its
    own equilibration, two presolved steps on the card against the CPU;
    refinement counts within one, fields to 1e-9 relative."""
    from pnp_tpu_torch.workloads import instationary_pnp_from_pb as W

    monkeypatch.setattr(W, "POISSON_INV_MAX_DOFS", 0)
    sys_, space = pore_case(30, 17)
    kw = dict(n_steps=2, presolve_potential=True, **BLOCK_RAS)
    K.reset_launch_counts()
    a = run_instationary_pnp_from_pb(sys_, space, device=cuda, **kw)
    assert K.launches["gj_inverse"] == 1 + 1       # Poisson, one RAS factor
    b = run_instationary_pnp_from_pb(sys_, space, device="cpu", **kw)
    assert a.system.poisson_tier == b.system.poisson_tier == "inverse_large"
    X_eq, s = a.system.poisson_pre
    assert X_eq.is_cuda and tuple(X_eq.shape) == (1, 488, 488)
    assert max(abs(p - q) for p, q in zip(a.poisson_iterations,
                                          b.poisson_iterations)) <= 1
    _fields_close(a, b, 1e-9)


def test_mid_species_tier_on_card_matches_cpu(cuda):
    """The mid-size species tier forced at 488 nodes: four presolved steps
    with a refresh every 2, the (2, 488, 488) stage inverses by kernel 1 at
    each refresh, on the card against the CPU; every window on inverses,
    refinement counts within one, fields to 1e-9 relative."""
    sys_, space = pore_case(30, 17)
    kw = dict(n_steps=4, presolve_potential=True, ras_refresh_every=2,
              species_inv_threshold=488, **BLOCK_RAS)
    K.reset_launch_counts()
    a = run_instationary_pnp_from_pb(sys_, space, device=cuda, **kw)
    assert K.launches["gj_inverse"] == 1 + 2       # Poisson, two refreshes
    b = run_instationary_pnp_from_pb(sys_, space, device="cpu", **kw)
    assert a.factor_kinds == b.factor_kinds == ["inv"] * 4
    assert max(abs(p - q) for p, q in zip(a.species_iterations,
                                          b.species_iterations)) <= 1
    _fields_close(a, b, 1e-9)


def test_other_workloads_on_card_match_cpu(cuda):
    """The stationary diffusion solve, the monolithic Newton solve from PB
    and five explicit steps on the card against the CPU, to 1e-9 relative;
    the two that bootstrap from PB launch kernel 2."""
    from pnp_tpu_torch.problems import one_wall_case
    from pnp_tpu_torch.workloads.instationary_pnp import run_instationary_pnp
    from pnp_tpu_torch.workloads.stationary_diffusion import (
        run_stationary_diffusion)
    from pnp_tpu_torch.workloads.stationary_pnp import run_stationary_pnp

    sys_, space = one_wall_case(40, 4)
    ua, ra = run_stationary_diffusion(sys_, space, 1e-12, device=cuda)
    ub, rb = run_stationary_diffusion(sys_, space, 1e-12, device="cpu")
    assert ua.is_cuda and abs(ra.iterations - rb.iterations) <= 1
    assert float((ua.cpu() - ub).abs().max()) <= 1e-9 * float(ub.abs().max())
    K.reset_launch_counts()
    na = run_stationary_pnp(sys_, space, from_pb=True, device=cuda)
    assert K.launches["pb_residual_jacobian"] > 0
    nb = run_stationary_pnp(sys_, space, from_pb=True, device="cpu")
    assert na.converged and na.iterations == nb.iterations
    assert float((na.u.cpu() - nb.u).abs().max()) <= 1e-9 * float(
        nb.u.abs().max())
    K.reset_launch_counts()
    ea = run_instationary_pnp(sys_, space, n_steps=5, device=cuda)
    assert K.launches["pb_residual_jacobian"] > 0
    eb = run_instationary_pnp(sys_, space, n_steps=5, device="cpu")
    assert ea.dt == eb.dt
    _fields_close(ea, eb, 1e-9)


def test_command_line_defaults_to_the_card(cuda, tmp_path):
    """``python -m pnp_tpu_torch`` without ``--device`` runs on the card."""
    import os
    import subprocess
    import sys

    from pnp_tpu_torch import problems

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys_, space = problems.one_wall_case(20, 3)
    problems.write_gmsh(space.mesh, str(tmp_path / "one_wall.msh"))
    problems.write_config(sys_, str(tmp_path / "one_wall.cfg"),
                          "one_wall.msh")
    r = subprocess.run(
        [sys.executable, "-m", "pnp_tpu_torch", "--steps", "2", "-o",
         str(tmp_path / "out"), str(tmp_path / "one_wall.cfg")],
        env=dict(os.environ, PYTHONPATH=repo), cwd=repo,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "device cuda" in r.stdout
    assert "assembled-solved DOFs/s" in r.stdout
    assert (tmp_path / "out" / "current.dat").exists()


def test_gj_kernel_at_the_schwarz_shapes(cuda):
    """Kernel 1 as the Schwarz local inverse: the (K, L, L) local matrices
    of a pore case's Poisson operator at K = 8 through
    ``schwarz.invert_local_matrices`` launch it once and agree with the
    plain version within GJ_REL_TOL, with its pivot rows; the species
    factor inverts the (2K, L, L) stage batch in one launch."""
    from pnp_tpu_torch.operators import volume as V
    from pnp_tpu_torch.solvers import schwarz as SW
    from pnp_tpu_torch.workloads import distributed_pnp as TD

    sys_, space = pore_case(60, 33)
    system = TD.build_dist_pnp_system(sys_, space, 8, device=cuda)
    ctx = system.ctx
    L = ctx.plan.B_N + ctx.plan.B_H
    ctx_phi = make_scalar_context(sys_, space, 0, 3, device="cpu")
    free = torch.as_tensor(
        ctx.partition(ctx_phi.free.numpy().astype(np.int8)).astype(bool)
        & ctx.pad_mask_flat(), device=cuda)
    A_phi = V.poisson_jacobian_el(TD.partition_volume_tables(ctx,
                                                             ctx_phi.vt),
                                  sys_.cylindrical, sys_.pi)
    A_loc = SW.build_local_matrices(ctx, A_phi, free)
    A = A_loc.to(torch.float32)
    assert tuple(A.shape) == (8, L, L)
    n0 = K.launches["gj_inverse"]
    X = SW.invert_local_matrices(ctx, A_loc)
    assert K.launches["gj_inverse"] == n0 + 1
    Xp = K.gj_inverse_plain(A)
    torch.testing.assert_close(X, Xp, rtol=0,
                               atol=GJ_REL_TOL * float(Xp.abs().max()))
    _, piv = K._gj_core_cuda(A)
    _, piv_p = K._gj_core_plain(A)
    assert torch.equal(piv.long(), piv_p)

    uphi = system.poisson_solve(system.uphi0, system.uc0)[0]
    n0 = K.launches["gj_inverse"]
    inv = system.species_factor(uphi)
    assert K.launches["gj_inverse"] == n0 + 1
    assert tuple(inv.shape) == (2, 8, L, L) and inv.dtype == torch.float32


def test_distributed_on_card_matches_cpu(cuda):
    """The owner-partitioned driver at K = 8 on the card against the CPU,
    2 steps of the one-wall case: fields to 1e-9 relative. Kernels 1 and 2
    launch; kernel 3 does not (the driver's owner-partitioned SpMV is its
    own)."""
    from pnp_tpu_torch.problems import one_wall_case
    from pnp_tpu_torch.workloads.distributed_pnp import \
        run_distributed_pnp_from_pb

    sys_, space = one_wall_case(40, 4)
    K.reset_launch_counts()
    a = run_distributed_pnp_from_pb(sys_, space, 8, n_steps=2, device=cuda)
    assert K.launches["gj_inverse"] > 0
    assert K.launches["pb_residual_jacobian"] > 0
    assert K.launches["element_spmv"] == 0
    b = run_distributed_pnp_from_pb(sys_, space, 8, n_steps=2, device="cpu")
    for name in ("phi", "cp", "cm"):
        x, y = getattr(a, name), getattr(b, name)
        assert np.abs(x - y).max() <= 1e-9 * np.abs(y).max()


def test_ranks_on_card_match_batch_axis(cuda, tmp_path):
    """``[procs gloo]`` at a small size: 2 gloo ranks x 2 shards on the
    card (``multiproc_smoke``, each rank on the current card) against the
    batch-axis driver at K = 4 in this process, 2 presolved steps of the
    one-wall case: one-level Schwarz, the same PB Newton count, fields and
    currents within 1e-8 of max + 1, kernels 1 and 2 launched on every
    rank and kernel 3 on none (the ranks' owner-partitioned SpMV is their
    own)."""
    import os
    import subprocess
    import sys

    from pnp_tpu_torch.problems import one_wall_case
    from pnp_tpu_torch.workloads.distributed_pnp import \
        run_distributed_pnp_from_pb

    out = tmp_path / "ranks.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-m", "pnp_tpu_torch.tools.multiproc_smoke",
         "--procs", "2", "--backend", "gloo", "--shards", "4", "--steps",
         "2", "--presolve", "--timeout", "300", "--out", str(out)],
        cwd=repo, capture_output=True, text=True, timeout=400)
    assert run.returncode == 0, run.stdout[-4000:]
    got = np.load(out)
    sys_, space = one_wall_case(40, 4)
    ref = run_distributed_pnp_from_pb(sys_, space, 4, n_steps=2,
                                      presolve_potential=True, device=cuda)
    assert str(got["poisson_tier"]) == ref.system.poisson_tier == "schwarz"
    assert int(got["pb_newton_iterations"]) == ref.pb_newton_iterations
    launches = dict(zip(got["kernel_names"].tolist(), got["launches"].T))
    for name in ("gj_inverse", "pb_residual_jacobian"):
        assert (launches[name] > 0).all(), launches
    assert (launches["element_spmv"] == 0).all(), launches
    scaled = lambda a, b: np.abs(a - b).max() / (np.abs(b).max() + 1.0)
    for name in ("phi", "cp", "cm"):
        assert scaled(got[name], getattr(ref, name)) <= 1e-8, name
    for (_, ip, im), gp, gm in zip(ref.current_history, got["ip"],
                                    got["im"]):
        assert max(scaled(gp, ip), scaled(gm, im)) <= 1e-8


def test_nccl_default_refuses_two_ranks_on_one_card(cuda, monkeypatch):
    """``initialize_distributed(backend=None)`` picks NCCL only where each
    rank has a card: more ranks than cards raise, naming gloo, before any
    connection is tried."""
    from pnp_tpu_torch.parallel import distributed as PD

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="gloo"):
        PD.initialize_distributed("127.0.0.1:1", n, 0, backend=None)
    assert PD.resolve_backend(None, torch.cuda.device_count()) == "nccl"


# --- kernel 3: constrained element-block SpMV -------------------------------

def spmv_forms(A, pair, dofmap, ndof, free):
    """(name, function of x) for every form the port calls."""
    from pnp_tpu_torch.fem import assembly as FA

    return [
        ("constrained", lambda x: FA.make_constrained_operator(
            A, dofmap, ndof, free[0])(x[0])),
        ("constrained pair", FA.make_constrained_operator(
            pair, dofmap, ndof, free)),
        ("one system, batched", lambda x: FA.make_constrained_operator(
            A[None], dofmap, ndof, free[:1])(x[:1])),
        ("shared blocks", lambda x: FA.spmv_batched(A[None], x, dofmap,
                                                    ndof)),
        ("unconstrained", lambda x: FA.spmv(A, x[0], dofmap, ndof)),
        ("unconstrained pair", lambda x: FA.spmv_batched(pair, x, dofmap,
                                                         ndof)),
    ]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("levels", [0, 3], ids=["L0", "L3"])
def test_element_spmv_matches_plain(cuda, levels, dtype):
    """Kernel 3 in every form the port calls, on the benchmark's meshes
    (3,105 and 189,697 nodes), against the plain version (the same calls
    on the CPU): one launch a call, constrained rows exactly x, the rest to
    round-off (f64 1e-13, f32 1e-5 of the output's scale)."""
    dofmap, ndof, A, pair, free, x = case_tensors(levels, cuda)
    A, pair, x = A.to(dtype), pair.to(dtype), x.to(dtype)
    cards = spmv_forms(A, pair, dofmap, ndof, free)
    plains = spmv_forms(A.cpu(), pair.cpu(), dofmap.cpu(), ndof, free.cpu())
    rtol = 1e-13 if dtype == torch.float64 else 1e-5
    for (name, card), (_, plain) in zip(cards, plains):
        n0 = K.launches["element_spmv"]
        got = card(x)
        assert K.launches["element_spmv"] == n0 + 1, name
        want = plain(x.cpu())
        assert got.shape == want.shape and got.dtype == dtype, name
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=rtol * float(want.abs().max()),
                                   msg=name)
    y = cards[1][1](x)
    assert torch.equal(y[~free], x[~free])


def test_element_spmv_is_one_launch_without_sync_and_repeats_bitwise(cuda):
    """At 189,697 nodes: an apply is one device kernel (the profiler sees
    nothing else), waits for nothing on the host
    (``torch.cuda.set_sync_debug_mode``, incidence table built inside the
    window included), and two applies give the same bits (no atomics)."""
    import warnings

    from pnp_tpu_torch.fem import assembly as FA

    dofmap, ndof, A, pair, free, x = case_tensors(3, cuda)
    K.build()
    dofmap = dofmap.clone()          # a dof map without a table yet
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            op = FA.make_constrained_operator(pair, dofmap, ndof, free)
            y1, y2 = op(x), op(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert not [w for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]
    assert torch.equal(y1, y2)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            op(x)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    counts = {e.key: e.count for e in prof.key_averages()
              if e.key in kernels}
    assert len(kernels) == 1 and "element_spmv" in kernels[0], counts
    assert counts[kernels[0]] == 3


def test_sharded_dofmap_keeps_its_scatter(cuda):
    """Element-sharded tables (one process, K = 4 shards) take the shards'
    partial scatter, not kernel 3, and agree with the whole dof map's
    apply."""
    from pnp_tpu_torch.fem import assembly as FA
    from pnp_tpu_torch.operators import volume as V
    from pnp_tpu_torch.parallel import sharding as S

    _, space = pore_case(30, 17)
    vt = build_volume_tables(space, 2, cuda)
    svt = S.shard_volume_tables(vt, S.make_device_mesh(4, device=cuda))
    assert isinstance(svt.dofmap, S.ShardedDofmap)
    A = V.laplace_jacobian_el(vt)
    A_s = V.laplace_jacobian_el(svt)
    x = torch.linspace(-1.0, 1.0, space.ndof, dtype=torch.float64,
                       device=cuda)
    free = x > -0.5
    n0 = K.launches["element_spmv"]
    got = FA.make_constrained_operator(A_s, svt.dofmap, space.ndof, free)(x)
    got_b = FA.spmv_batched(A_s[None], x[None], svt.dofmap, space.ndof)
    assert K.launches["element_spmv"] == n0
    want = FA.make_constrained_operator(A, vt.dofmap, space.ndof, free)(x)
    assert K.launches["element_spmv"] == n0 + 1
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-13 * float(want.abs().max()))
    torch.testing.assert_close(got_b[0], FA.spmv(A, x, vt.dofmap, space.ndof),
                               rtol=0, atol=1e-13 * float(want.abs().max()))


def test_cg_amg_graph_replays_the_eager_iteration(cuda):
    """CG under the two-level AMG on the card, two systems, restarted every
    4 iterations: the solver's CUDA-graph loop, a device-side loop a
    segment between restarts, gives the eager loop's iteration count,
    relative residuals and bits, counts every kernel's launches in the
    loops as the eager loop counts them (the capture launches nothing;
    ``cg_update`` once an iteration, ``cg_direction`` once an iteration
    that is no restart), records
    one capture, a loop for the first segment and one after each restart
    that is not the last iteration, and a replay for every iteration but
    the first and the restarts, allocates at its peak no more than 4 MiB
    beyond the eager loop's (no library workspace for the capture stream),
    and a third solve reserves no more memory than the second (the
    captures share one pool)."""
    from pnp_tpu_torch.fem import assembly as FA
    from pnp_tpu_torch.operators import volume as V
    from pnp_tpu_torch.solvers import amg, krylov
    from pnp_tpu_torch.solvers import linear_problem as LP

    space = FunctionSpace(rect_mesh(48, 48, 1.0, 1.0), 1)
    vt = build_volume_tables(space, 2, cuda)
    n = space.ndof
    A = V.laplace_jacobian_el(vt)
    A_el = torch.stack([A, 2.0 * A])
    free = torch.ones((2, n), dtype=torch.bool, device=cuda)
    edge = torch.as_tensor(space.bedge_dofs, device=cuda).unique()
    free[0, edge] = False
    free[1, edge[::2]] = False
    op = FA.make_constrained_operator(A_el, vt.dofmap, n, free)
    diag = torch.where(free, FA.scatter_add_batched(torch.diagonal(
        A_el, dim1=-2, dim2=-1), vt.dofmap, n), 1.0)
    t = torch.arange(n, dtype=torch.float64, device=cuda)
    b = torch.stack([torch.sin(t), torch.cos(0.5 * t)]) * free
    ctx = amg.make_amg_context(vt.dofmap, n, free, 64,
                               dof_coords=space.dof_coords)
    K.build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    n0 = dict(K.launches)
    eager = krylov.cg(op, b, torch.zeros_like(b),
                      amg.two_level_precond(A_el, ctx, diag), 1e-10, 2000,
                      restart=4)
    n_eager = {k: K.launches[k] - n0[k] for k in n0}
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    solve = LP.make_krylov_solver("CG_AMG_SSOR", 2000, amg_ctx=ctx,
                                  cg_restart=4)
    counts = dict(krylov.graph_counts)
    n0 = dict(K.launches)
    got = solve(op, b, torch.zeros_like(b), diag, 1e-10, A_el=A_el)
    n_graph = {k: K.launches[k] - n0[k] for k in n0}
    torch.cuda.synchronize()
    peak_graph = torch.cuda.max_memory_allocated(cuda)
    assert peak_graph - peak_eager < 4 * 2 ** 20, (peak_graph, peak_eager)
    assert eager.converged and eager.iterations > 8
    assert got.iterations == eager.iterations
    assert torch.equal(got.x, eager.x)
    assert torch.equal(got.relres, eager.relres)
    assert n_graph == n_eager, (n_graph, n_eager)
    k = eager.iterations
    assert n_eager["cg_update"] == k and n_eager["cg_direction"] == k - k // 4
    assert krylov.graph_counts == {
        "captures": counts["captures"] + 1,
        "replays": counts["replays"] + k - 1 - k // 4,
        "loops": counts["loops"] + 1 + (k - 1) // 4}
    solve(op, b, torch.zeros_like(b), diag, 1e-10, A_el=A_el)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(cuda)
    again = solve(op, b, torch.zeros_like(b), diag, 1e-10, A_el=A_el)
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved(cuda) == reserved
    assert torch.equal(again.x, eager.x)


@pytest.mark.parametrize("case", ["two-level", "pair"])
def test_bicgstab_ras_graph_replays_the_eager_iteration(cuda, case):
    """BiCGSTAB under block RAS on the card: one system under two-level RAS
    with the p1 coarse level, or two systems with other blocks and masks
    under RAS. The solver's CUDA-graph loop gives the eager loop's
    iteration count, relative residuals and bits, counts kernel 3's
    launches in its device-side loop as the eager loop counts them (the
    capture launches nothing), records one capture, one loop and a replay
    for every iteration after the first, allocates at its peak no more
    than cuBLAS's 32 MiB workspace for the capture stream and 4 MiB beyond
    the eager loop's, and a third solve reserves no more memory than the
    second (the captures share one pool)."""
    from pnp_tpu_torch.fem import assembly as FA
    from pnp_tpu_torch.operators import volume as V
    from pnp_tpu_torch.solvers import block_ras as BR
    from pnp_tpu_torch.solvers import krylov

    space = FunctionSpace(rect_mesh(64, 64, 1.0, 1.0), 1)
    vt = build_volume_tables(space, 2, cuda)
    n = space.ndof
    A = V.laplace_jacobian_el(vt)
    edge = torch.as_tensor(space.bedge_dofs, device=cuda).unique()
    ctx = BR.build_block_context_for_space(space, 256, cuda)
    K.build()
    t = torch.arange(n, dtype=torch.float64, device=cuda)
    if case == "two-level":
        free = torch.ones(n, dtype=torch.bool, device=cuda)
        free[edge] = False
        op = FA.make_constrained_operator(A, vt.dofmap, n, free)
        inv = BR.build_local_inverses(ctx, A, free)
        M = BR.make_two_level_precond(
            ctx, inv, None, op, free, p1_coarse=BR.build_p1_coarse(
                ctx, A, vt.dofmap, free, space.dof_coords))
        b = torch.sin(t) * free
    else:
        A_el = torch.stack([A, 2.0 * A])
        free = torch.ones((2, n), dtype=torch.bool, device=cuda)
        free[0, edge] = False
        free[1, edge[::2]] = False
        op = FA.make_constrained_operator(A_el, vt.dofmap, n, free)
        M = BR.make_ras_precond(ctx, BR.build_local_inverses(ctx, A_el, free),
                                free)
        b = torch.stack([torch.sin(t), torch.cos(0.5 * t)]) * free
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    n0 = K.launches["element_spmv"]
    eager = krylov.bicgstab(op, b, torch.zeros_like(b), M, 1e-10, 2000)
    n_eager = K.launches["element_spmv"] - n0
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    counts = dict(krylov.graph_counts)
    n0 = K.launches["element_spmv"]
    got = krylov.bicgstab(op, b, torch.zeros_like(b), M, 1e-10, 2000,
                          graph=True)
    n_graph = K.launches["element_spmv"] - n0
    torch.cuda.synchronize()
    peak_graph = torch.cuda.max_memory_allocated(cuda)
    assert peak_graph - peak_eager <= 36 * 2 ** 20, (
        "more than cuBLAS's 32 MiB workspace for the capture stream and "
        "4 MiB above the eager loop's peak", peak_graph, peak_eager)
    assert eager.converged and eager.iterations > 4
    assert got.iterations == eager.iterations
    assert torch.equal(got.x, eager.x)
    assert torch.equal(got.relres, eager.relres)
    assert n_graph == n_eager, (n_graph, n_eager)
    assert krylov.graph_counts == {
        "captures": counts["captures"] + 1,
        "replays": counts["replays"] + eager.iterations - 1,
        "loops": counts["loops"] + 1}
    krylov.bicgstab(op, b, torch.zeros_like(b), M, 1e-10, 2000, graph=True)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(cuda)
    again = krylov.bicgstab(op, b, torch.zeros_like(b), M, 1e-10, 2000,
                            graph=True)
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved(cuda) == reserved
    assert torch.equal(again.x, eager.x)


def _amg_pair(cuda):
    """Two constrained Poisson systems on a 48 x 48 square under the
    two-level AMG: the operator, its blocks, the diagonal, a right-hand
    side and the AMG context."""
    from pnp_tpu_torch.fem import assembly as FA
    from pnp_tpu_torch.operators import volume as V
    from pnp_tpu_torch.solvers import amg

    space = FunctionSpace(rect_mesh(48, 48, 1.0, 1.0), 1)
    vt = build_volume_tables(space, 2, cuda)
    n = space.ndof
    A = V.laplace_jacobian_el(vt)
    A_el = torch.stack([A, 2.0 * A])
    free = torch.ones((2, n), dtype=torch.bool, device=cuda)
    edge = torch.as_tensor(space.bedge_dofs, device=cuda).unique()
    free[0, edge] = False
    free[1, edge[::2]] = False
    op = FA.make_constrained_operator(A_el, vt.dofmap, n, free)
    diag = torch.where(free, FA.scatter_add_batched(torch.diagonal(
        A_el, dim1=-2, dim2=-1), vt.dofmap, n), 1.0)
    t = torch.arange(n, dtype=torch.float64, device=cuda)
    b = torch.stack([torch.sin(t), torch.cos(0.5 * t)]) * free
    ctx = amg.make_amg_context(vt.dofmap, n, free, 64,
                               dof_coords=space.dof_coords)
    return op, A_el, diag, b, ctx


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_graph_loop_stops_at_maxiter(cuda, solver):
    """A graphed solve whose ``maxiter`` falls inside a device-side loop
    (CG under the two-level AMG restarted every 4, stopped after 10
    iterations: loops over 2-3, 5-7 and 9-10; BiCGSTAB under the same
    preconditioner, stopped after 6: one loop over 2-6) stops where the
    eager loop stops: ``iterations == maxiter``, not converged, the same
    relative residuals and bits."""
    from pnp_tpu_torch.solvers import amg, krylov

    op, A_el, diag, b, ctx = _amg_pair(cuda)
    K.build()
    M = amg.two_level_precond(A_el, ctx, diag)
    if solver == "cg":
        maxiter, loops = 10, 3

        def solve(graph):
            return krylov.cg(op, b, torch.zeros_like(b), M, 1e-14, maxiter,
                             restart=4, graph=graph)
    else:
        maxiter, loops = 6, 1

        def solve(graph):
            return krylov.bicgstab(op, b, torch.zeros_like(b), M, 1e-14,
                                   maxiter, graph=graph)
    eager = solve(False)
    counts = dict(krylov.graph_counts)
    got = solve(True)
    assert eager.iterations == got.iterations == maxiter
    assert not eager.converged and not got.converged
    assert torch.equal(got.relres, eager.relres)
    assert torch.equal(got.x, eager.x)
    assert krylov.graph_counts["captures"] == counts["captures"] + 1
    assert krylov.graph_counts["loops"] == counts["loops"] + loops


def test_graph_loop_frees_the_last_one_at_the_next_capture(cuda):
    """Each graphed solve captures anew and frees the loop the solve
    before made (its graphs and the memory of its capture go back to the
    shared pool): over five solves of one system the earlier loops hold
    no handle, the last one does, each solve gives the first one's bits,
    and the memory reserved after the second solve stays as it is."""
    from pnp_tpu_torch.solvers import amg, krylov

    op, A_el, diag, b, ctx = _amg_pair(cuda)
    K.build()
    M = amg.two_level_precond(A_el, ctx, diag)

    def solve():
        return krylov.cg(op, b, torch.zeros_like(b), M, 1e-10, 2000,
                         restart=4, graph=True)

    first = solve()
    env = krylov._graph_env[b.device]
    made, reserved = [env[2]], []
    for _ in range(4):
        again = solve()
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(cuda))
        made.append(env[2])
        assert torch.equal(again.x, first.x)
    assert len({id(loop) for loop in made}) == len(made)
    assert all(loop._handle is None for loop in made[:-1])
    assert made[-1]._handle is not None
    assert reserved == [reserved[0]] * len(reserved), reserved


@pytest.mark.parametrize("rows", [1, 2])
def test_cg_update_kernels_give_the_torch_operations_bits(cuda, rows):
    """``csrc/cg_update.cu`` on the card against the torch operations it
    replaces, run on the same CUDA tensors, bit for bit: cg_update and
    cg_direction over 189,697 values a row (a zero where a divisor is
    taken), the flag both ways; one launch each, counted."""
    n = 189_697
    g = torch.Generator(device=cuda).manual_seed(rows)

    def rand(shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=cuda)

    x, r, p, Ap, z = (rand((rows, n)) for _ in range(5))
    pAp, rz, rz_new = (rand((rows, 1)) for _ in range(3))
    pAp[0], rz[-1] = 0.0, 0.0
    want = [v.clone() for v in (x, r, p)]
    K.cg_update_plain(want[0], want[1], p, Ap, pAp, rz)
    K.cg_direction_plain(want[2], z, rz_new, rz)
    counts = dict(K.launches)
    K.cg_update(x, r, p, Ap, pAp, rz)
    K.cg_direction(p, z, rz_new, rz)
    assert torch.equal(x, want[0]) and torch.equal(r, want[1])
    assert torch.equal(p, want[2])
    ss = (r.double() ** 2).sum(-1, keepdim=True)
    for scale in (0.5, 2.0):
        tol = torch.sqrt(ss) * scale
        tol[0] = torch.sqrt(ss[0])
        flag = K.krylov_unconverged(ss, tol)
        assert flag.dtype == torch.bool and flag.shape == ()
        assert bool(flag) == bool(K.krylov_unconverged_plain(ss, tol)) \
            == (scale < 1.0 and rows > 1)
    assert {k: K.launches[k] - counts[k] for k in counts} == {
        **{k: 0 for k in counts}, "cg_update": 1, "cg_direction": 1,
        "krylov_unconverged": 2}

"""The port's main path against the reference package on the CPU:
``run_instationary_pnp_from_pb`` on the 488-node pore case, presolved, 3
steps. PB field, phi, c+-, ion currents and ``current.dat`` agree to 1e-10
relative: with refinement run to convergence, swapping the f32 stage
inverse for another one moves the trajectory by ~5e-15, so the bound holds
though the port's Gauss-Jordan inverse rounds differently from XLA's."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import pore_without_dna_mesh
from pnp_tpu.workloads import instationary_pnp_from_pb as JW

from pnp_tpu_torch import interop, problems
from pnp_tpu_torch.operators import kernels as K
from pnp_tpu_torch.timestepping.tableaux import Tableau
from pnp_tpu_torch.workloads import instationary_pnp_from_pb as TW

from test_torch_host import jax_sysparams

torch.set_num_threads(1)

RTOL = 1e-10
STEPS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("slice")
    tsys, tspace = problems.pore_case(30, 17)
    jsys = jax_sysparams(tsys)
    jspace = JFS(pore_without_dna_mesh(30, 17), 1)
    jr = JW.run_instationary_pnp_from_pb(
        jsys, jspace, n_steps=STEPS, presolve_potential=True,
        output_dir=str(out / "jax"))
    tr = TW.run_instationary_pnp_from_pb(
        tsys, tspace, n_steps=STEPS, presolve_potential=True,
        output_dir=str(out / "port"), checkpoint_path=str(out / "ck.npz"),
        checkpoint_freq=2, device="cpu")
    return jr, tr, out, tsys, tspace, jsys, jspace


def test_slice_matches_reference(runs):
    jr, tr, *_ = runs
    assert tr.pb_newton_iterations == jr.pb_newton_iterations == 4
    assert (tr.steps, tr.time) == (jr.steps, jr.time)
    for name in ("phi", "cp", "cm"):
        got = getattr(tr, name)
        assert got.dtype == torch.float64 and torch.isfinite(got).all()
        assert rel(got, getattr(jr, name)) <= RTOL, name
    assert len(tr.current_history) == len(jr.current_history) == STEPS
    for (ta, ipa, ima), (tb, ipb, imb) in zip(tr.current_history,
                                              jr.current_history):
        assert ta == tb
        assert rel(ipa, ipb) <= RTOL and rel(ima, imb) <= RTOL
    assert len(tr.step_ms) == STEPS and tr.species_iterations == [4] * STEPS
    assert tr.poisson_iterations == [1] * STEPS
    assert tr.factor_rebuilt == [True] * STEPS


def test_pb_field_matches_reference(runs):
    *_, tsys, tspace, jsys, jspace = runs
    jsys_ = JW.build_pnp_system(jsys, jspace)
    tsys_ = TW.build_pnp_system(tsys, tspace, device="cpu")
    assert rel(tsys_.pb, jsys_.pb) <= RTOL
    for name in ("uphi0", "ucp0", "ucm0"):
        assert rel(getattr(tsys_, name), getattr(jsys_, name)) <= RTOL
    # the fused step and its loop form agree with the reference's
    state_t = (tsys_.uphi0, tsys_.ucp0, tsys_.ucm0)
    state_j = (jsys_.uphi0, jsys_.ucp0, jsys_.ucm0)
    state_t = (tsys_.poisson_solve(*state_t)[0],) + state_t[1:]
    state_j = (jsys_.poisson_solve(*state_j)[0],) + state_j[1:]
    for a, b in zip(tsys_.scan_steps(state_t, 2), jsys_.scan_steps(state_j, 2)):
        assert rel(a, b) <= RTOL
    A32 = tsys_.species_dense_f32(state_t[0])
    assert rel(A32, jsys_.species_dense_f32(state_j[0])) <= 1e-6   # f32
    # the reference's PB field carried across skips the port's phase A
    carried = TW.build_pnp_system(tsys, tspace,
                                  pb_field=interop.field(jsys_.pb),
                                  device="cpu")
    assert carried.pb_newton_iterations == 0
    assert rel(carried.ucm0, jsys_.ucm0) <= RTOL


def test_outputs_match_reference(runs):
    _, _, out, *_ = runs
    jrows = (out / "jax" / "current.dat").read_text().split("\n")
    trows = (out / "port" / "current.dat").read_text().split("\n")
    assert len(trows) == len(jrows) == STEPS + 1          # + trailing ""
    for a, b in zip(trows[:-1], jrows[:-1]):
        fa, fb = a.split(), b.split()
        assert len(fa) == len(fb) == 13 and fa[0] == fb[0]
        assert rel([float(x) for x in fa[1:]],
                   [float(x) for x in fb[1:]]) <= RTOL
    names = sorted(os.listdir(out / "jax"))
    assert sorted(os.listdir(out / "port")) == names
    assert "data003.vtu" in names and "cm003.dat" in names


def test_checkpoint_resume(runs):
    """Resume from the step-2 checkpoint reproduces the uninterrupted run."""
    _, tr, out, tsys, tspace, *_ = runs
    resumed = TW.run_instationary_pnp_from_pb(
        tsys, tspace, n_steps=STEPS, presolve_potential=True,
        checkpoint_path=str(out / "ck.npz"), resume=True, device="cpu")
    assert len(resumed.current_history) == STEPS - 2
    for name in ("phi", "cp", "cm"):
        assert rel(getattr(resumed, name), getattr(tr, name)) <= 1e-13


def test_non_finite_guard(runs, monkeypatch):
    """A non-finite state dumps an emergency checkpoint and raises."""
    _, _, out, tsys, tspace, *_ = runs
    build = TW.build_pnp_system

    def poisoned(*a, **kw):
        system = build(*a, **kw)
        step = system.species_step
        system.species_step = lambda u, cp, cm: (
            step(u, cp, cm)[0] * float("nan"), cm, 1)
        return system

    monkeypatch.setattr(TW, "build_pnp_system", poisoned)
    ck = str(out / "guard.npz")
    with pytest.raises(FloatingPointError, match="non-finite"):
        TW.run_instationary_pnp_from_pb(tsys, tspace, n_steps=1,
                                        checkpoint_path=ck, device="cpu")
    assert os.path.exists(ck + ".emergency")


def test_unported_tiers_raise():
    """Above the dense threshold the block-RAS tier builds, and a tableau
    whose stage diagonals differ takes the species Krylov path; the
    mid-size species tier builds where ``species_inv_threshold`` admits
    the mesh; ``CG_AMG_SSOR`` on element-sharded tables whose element
    count (852) the shard count (8) does not divide raises ValueError, as
    the reference's build fails there."""
    tsys, tspace = problems.pore_case(30, 17)
    system = TW.build_pnp_system(tsys, tspace, dense_poisson_threshold=100,
                                 device="cpu")
    assert (system.factor_kind, system.poisson_tier) == ("ras", "inverse")
    assert system.block_context.K == 2
    mid = TW.build_pnp_system(tsys, tspace, dense_poisson_threshold=100,
                              species_inv_threshold=1000, pb_field=system.pb,
                              device="cpu")
    assert (mid.factor_kind, mid.poisson_tier) == ("ras", "inverse")
    uphi, _ = mid.poisson_solve(mid.uphi0, mid.ucp0, mid.ucm0)
    kind, X = mid.species_factor(uphi)
    assert kind == "inv" and tuple(X.shape) == (2, 488, 488)
    assert X.dtype == torch.float32
    with pytest.raises(ValueError, match="divides the element count"):
        TW.build_pnp_system(
            dataclasses.replace(tsys, linearSolver="CG_AMG_SSOR"), tspace,
            device_mesh=8, device="cpu")
    skewed = Tableau("skewed", A=np.array([[-1.0, 1.0, 0.0],
                                           [-1.0, 0.0, 1.0]]),
                     B=np.array([[0.0, 0.3, 0.0], [0.0, 0.5, 0.4]]),
                     D=np.array([0.0, 0.3, 1.0]), implicit=True)
    # stage diagonals that differ no longer raise: the species Krylov
    # path, with no factor to reuse (tests/test_torch_species_krylov.py)
    krylov = TW.build_pnp_system(tsys, tspace, tableau=skewed, device="cpu")
    assert krylov.factor_kind is None and krylov.species_factor is None
    assert krylov.lam_species is not None


def test_cpu_run_launches_no_kernel(runs):
    """The CPU path takes the plain versions: the counters stay put."""
    _, _, _, tsys, tspace, *_ = runs
    K.reset_launch_counts()
    TW.run_instationary_pnp_from_pb(tsys, tspace, n_steps=1, device="cpu")
    assert set(K.launches.values()) == {0}


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import pnp_tpu_torch\n"
            "from pnp_tpu_torch.problems import pore_case\n"
            "from pnp_tpu_torch.workloads.instationary_pnp_from_pb import "
            "run_instationary_pnp_from_pb\n"
            "r = run_instationary_pnp_from_pb(*pore_case(30, 17), n_steps=1,"
            " presolve_potential=True, device='cpu')\n"
            "assert bool(r.phi.isfinite().all())\n"
            "b = run_instationary_pnp_from_pb(*pore_case(30, 17), n_steps=1,"
            " presolve_potential=True, dense_poisson_threshold=0,"
            " ras_block_size=64, poisson_inv_threshold=0, device='cpu')\n"
            "assert b.system.factor_kind == 'ras' and "
            "b.system.poisson_tier == 'ras'\n"
            "assert bool(b.phi.isfinite().all())\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pnp_tpu'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout

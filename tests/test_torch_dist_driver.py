"""The port's owner-partitioned production driver against the reference
package's (``pnp_tpu.workloads.distributed_pnp``, its shards on the 8
virtual devices of tests/conftest.py) and against the port's
single-device driver, on the CPU, on ``one_wall_case(40, 4)`` at K = 8:
fields and currents to 1e-8 (measured 3e-14 against the reference, 1e-11
against the single-device driver), the outputs, current.dat across shard
counts, a K = 8 checkpoint resumed under K = 4, the factor reuse
schedule, the non-finite guard and the entry checks. The reference runs
once in this module. Model: tests/test_dist_driver.py."""

import os

import jax
import numpy as np
import pytest
import torch

from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import rect_mesh
from pnp_tpu.parallel.dist import build_dist_context as j_dist
from pnp_tpu.parallel.sharding import make_device_mesh
from pnp_tpu.workloads import distributed_pnp as JD

from pnp_tpu_torch import interop, problems
from pnp_tpu_torch.parallel.dist import build_dist_context as t_dist
from pnp_tpu_torch.workloads import distributed_pnp as TD
from pnp_tpu_torch.workloads import instationary_pnp_from_pb as TW

from test_torch_host import jax_sysparams

torch.set_num_threads(1)

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")
N_STEPS = 4
ATOL = 1e-8


def worst(a, b) -> float:
    """Largest field difference of two runs, and of their currents."""
    fields = max(float(np.abs(np.asarray(getattr(a, n))
                              - np.asarray(getattr(b, n))).max())
                 for n in ("phi", "cp", "cm"))
    cur = max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
              for (_, *xs), (_, *ys) in zip(a.current_history,
                                            b.current_history)
              for x, y in zip(xs, ys))
    return max(fields, cur)


@pytest.fixture(scope="module")
def case():
    tsys, tspace = problems.one_wall_case(40, 4)
    return tsys, tspace


@pytest.fixture(scope="module")
def run8(case, tmp_path_factory):
    tsys, tspace = case
    out = tmp_path_factory.mktemp("dist8")
    res = TD.run_distributed_pnp_from_pb(
        tsys, tspace, 8, n_steps=N_STEPS, output_dir=str(out),
        checkpoint_path=str(out / "ck.npz"), checkpoint_freq=3,
        device="cpu")
    return res, out


@needs_8
def test_driver_outputs_written(case, run8):
    tsys, tspace = case
    res, out = run8
    assert res.steps == N_STEPS and res.n_shards == 8
    assert len(res.current_history) == N_STEPS     # outputFreq 1
    assert res.system.poisson_tier == "schwarz"
    assert res.factor_rebuilt == [True] * N_STEPS
    assert len(res.step_ms) == len(res.species_iterations) == N_STEPS
    assert all(k > 0 for k in res.species_iterations)
    assert all(k > 0 for k in res.poisson_iterations)
    assert res.pb_newton_iterations > 0 and res.pb_jacobian_builds > 0
    names = sorted(os.listdir(out))
    for expected in ("current.dat", "phi.dat", "phi001.dat", "phi004.dat",
                     "cp.dat", "data001.vtu", "data004.vtu", "ck.npz"):
        assert expected in names, (expected, names)
    for v in (res.phi, res.cp, res.cm):
        assert v.shape == (tspace.ndof,) and np.isfinite(v).all()


@needs_8
def test_matches_reference_and_single_device(case, run8, tmp_path):
    """The same phases A-D as the reference's distributed driver (the same
    PB Newton iterations and Jacobian builds) and as the port's
    single-device driver: fields, currents and current.dat to 1e-8."""
    tsys, tspace = case
    res, out = run8
    jspace = JFS(rect_mesh(40, 4, 5.0, 0.5), 1)
    ref = JD.run_distributed_pnp_from_pb(
        jax_sysparams(tsys), jspace, make_device_mesh(8), n_steps=N_STEPS,
        output_dir=str(tmp_path / "ref"))
    assert res.pb_newton_iterations == int(ref.pb_newton_iterations)
    assert res.pb_jacobian_builds == int(ref.pb_jacobian_builds)
    assert ref.n_devices == res.n_shards
    assert worst(res, ref) <= ATOL, worst(res, ref)
    c_t = np.loadtxt(out / "current.dat")
    c_j = np.loadtxt(tmp_path / "ref" / "current.dat")
    assert c_t.shape == c_j.shape
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=ATOL)
    single = TW.run_instationary_pnp_from_pb(tsys, tspace, n_steps=N_STEPS,
                                             device="cpu")
    assert worst(res, single) <= ATOL, worst(res, single)


@needs_8
def test_current_dat_identical_across_shard_counts(case, run8, tmp_path):
    """Output goes through the global host vectors, so current.dat is a
    function of the trajectory only: K = 2 and K = 8 agree to 1e-8."""
    tsys, tspace = case
    _, out8 = run8
    res2 = TD.run_distributed_pnp_from_pb(
        tsys, tspace, 2, n_steps=N_STEPS, output_dir=str(tmp_path),
        device="cpu")
    assert res2.n_shards == 2
    np.testing.assert_allclose(np.loadtxt(tmp_path / "current.dat"),
                               np.loadtxt(out8 / "current.dat"), rtol=0,
                               atol=ATOL)


@needs_8
def test_checkpoint_resume_across_shard_counts(case, run8):
    """A checkpoint written under K = 8 (after step 3) resumes under
    K = 4 and lands on the full run's state."""
    tsys, tspace = case
    full, out8 = run8
    resumed = TD.run_distributed_pnp_from_pb(
        tsys, tspace, 4, n_steps=N_STEPS,
        checkpoint_path=str(out8 / "ck.npz"), resume=True, device="cpu")
    assert len(resumed.step_ms) == 1 and resumed.time == pytest.approx(
        full.time)
    for n in ("phi", "cp", "cm"):
        np.testing.assert_allclose(getattr(resumed, n), getattr(full, n),
                                   rtol=0, atol=ATOL)


@needs_8
def test_schwarz_factor_reuse_matches(case, run8):
    """``ras_refresh_every=4``: one species factor for the 4 steps; the
    stale factor only moves iteration counts, the trajectory stays within
    1e-7 of the fresh-factor run."""
    tsys, tspace = case
    fresh, _ = run8
    reuse = TD.run_distributed_pnp_from_pb(
        tsys, tspace, 8, n_steps=N_STEPS, ras_refresh_every=4, device="cpu")
    assert reuse.factor_rebuilt == [True, False, False, False]
    for n in ("phi", "cp", "cm"):
        np.testing.assert_allclose(getattr(reuse, n), getattr(fresh, n),
                                   rtol=0, atol=1e-7)


@needs_8
def test_entry_points_and_state_carrier(case, tmp_path, monkeypatch):
    """A shard count below one is refused; a tableau whose stage diagonals
    differ has no factor to reuse and steps with each stage's own Schwarz
    inverses; ``scan_steps`` is the ``fused_step`` loop; a non-finite
    state trips the guard and leaves an emergency checkpoint;
    ``interop.dist_state`` carries an owner-partitioned state between two
    plans (the reference's and the port's, K = 8 -> K = 4)."""
    tsys, tspace = case
    with pytest.raises(ValueError):
        TD.build_dist_pnp_system(tsys, tspace, 0, device="cpu")
    base = TW.build_pnp_system(tsys, tspace, device="cpu")
    pb = base.pb.numpy()
    subs = TD.build_dist_pnp_system(tsys, tspace, 4, pb_field=pb,
                                    tableau=problems.substeps_tableau(),
                                    device="cpu")
    assert subs.species_factor is None and subs.fused_step_reuse is None
    uc, k = subs.species_step(subs.uphi0, subs.uc0)
    assert k > 0 and bool(torch.isfinite(uc).all())
    system = TD.build_dist_pnp_system(tsys, tspace, 4, pb_field=pb,
                                      device="cpu")
    s = (system.uphi0, system.uc0)
    looped = system.fused_step(*system.fused_step(*s))
    for a, b in zip(system.scan_steps(s, 2), looped):
        assert torch.equal(a, b)

    # a species step that returns NaN: the guard after the last step
    real = TD.build_dist_pnp_system

    def poisoned(*args, **kw):
        sys_ = real(*args, **kw)
        sys_.species_step = lambda uphi, uc: (uc * float("nan"), 1)
        return sys_

    monkeypatch.setattr(TD, "build_dist_pnp_system", poisoned)
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(FloatingPointError, match="non-finite state at step 2"):
        TD.run_distributed_pnp_from_pb(tsys, tspace, 2, n_steps=2,
                                       pb_field=pb, checkpoint_path=ck,
                                       device="cpu")
    assert os.path.exists(ck + ".emergency") and not os.path.exists(ck)
    monkeypatch.undo()

    rng = np.random.RandomState(5)
    x = rng.standard_normal(tspace.ndof)
    c = rng.standard_normal((2, tspace.ndof))
    jc = j_dist(JFS(rect_mesh(40, 4, 5.0, 0.5), 1), make_device_mesh(8))
    tc8 = t_dist(tspace, 8, "cpu")
    uphi, ucs = interop.dist_state(jc.partition(x),
                                   np.stack([jc.partition(v) for v in c]),
                                   jc.plan, tc8)
    assert uphi.dtype == torch.float64 and tuple(ucs.shape) == (2, tc8.Kb)
    np.testing.assert_array_equal(uphi.numpy(), tc8.partition(x))
    tc4 = t_dist(tspace, 4, "cpu")
    uphi4, ucs4 = interop.dist_state(uphi.numpy(), ucs.numpy(), tc8.plan,
                                     tc4)
    np.testing.assert_array_equal(tc4.to_host_global(uphi4), x)
    np.testing.assert_array_equal(tc4.to_host_global(ucs4), c)

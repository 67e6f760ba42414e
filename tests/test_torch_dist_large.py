"""The port's owner-partitioned driver on both Poisson tiers against the
port's single-device driver, on the CPU, with the PB field shared: the
pore case presolved (``pore_case(30, 17)``, K = 8, one-level Schwarz;
within 2e-4 of the scale, the reference's stage-slack bound between its
distributed and single-chip drivers, tests/test_dist_driver.py:139-149),
and the two-level Schwarz tier above 8,192 dofs (``one_wall_case(200,
40)``, 8,241 dofs, K = 8; to 1e-8). Models: tests/test_dist_driver.py,
tests/test_dist_large.py."""

import numpy as np
import torch

from pnp_tpu_torch import problems
from pnp_tpu_torch.postprocess.ionflux import calc_ion_flux
from pnp_tpu_torch.workloads import distributed_pnp as TD
from pnp_tpu_torch.workloads import instationary_pnp_from_pb as TW

torch.set_num_threads(1)

STAGE_SLACK = 2e-4


def scaled(a, b) -> float:
    """max |a - b| / (max |b| + 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1.0))


def test_pore_presolved_matches_single_device(tmp_path):
    """3 presolved steps of the pore case at K = 8 against the single-device
    dense tier on the same PB field: fields and current.dat within 2e-4 of
    the scale (measured below 1e-9)."""
    tsys, tspace = problems.pore_case(30, 17)
    single = TW.run_instationary_pnp_from_pb(
        tsys, tspace, n_steps=3, presolve_potential=True,
        output_dir=str(tmp_path / "single"), device="cpu")
    dist = TD.run_distributed_pnp_from_pb(
        tsys, tspace, 8, n_steps=3, presolve_potential=True,
        pb_field=single.system.pb.numpy(),
        output_dir=str(tmp_path / "dist"), device="cpu")
    assert dist.system.poisson_tier == "schwarz"
    assert dist.pb_newton_iterations == 0
    for n in ("phi", "cp", "cm"):
        got = getattr(dist, n)
        assert np.isfinite(got).all()
        assert scaled(got, getattr(single, n).numpy()) < STAGE_SLACK, n
    c_d = np.loadtxt(tmp_path / "dist" / "current.dat")
    c_s = np.loadtxt(tmp_path / "single" / "current.dat")
    assert c_d.shape == c_s.shape == (3, 1 + 2 * tsys.n_surfaces)
    assert scaled(c_d, c_s) < STAGE_SLACK


def test_two_level_tier_above_8192_dofs():
    """``one_wall_case(200, 40)`` (8,241 dofs) at K = 8 takes the two-level
    Schwarz Poisson (the local inverses and the per-shard linear coarse
    level, built once), 2 steps from its own distributed PB solve, against
    the single-device driver on that PB field (block-RAS tier, two-level
    RAS Poisson): fields and currents to 1e-8 (measured 4e-12)."""
    tsys, tspace = problems.one_wall_case(200, 40)
    assert tspace.ndof == 8241
    dist = TD.run_distributed_pnp_from_pb(tsys, tspace, 8, n_steps=2,
                                          device="cpu")
    assert dist.system.poisson_tier == "two_level"
    assert dist.pb_newton_iterations > 0
    # the single-device driver's fresh-factor steps, as the distributed
    # run takes them (ras_refresh_every 1), on the same PB field
    single = TW.build_pnp_system(
        tsys, tspace, pb_field=dist.system.to_global(dist.system.pb),
        poisson_inv_threshold=0, device="cpu")
    assert single.poisson_tier == "ras"
    state = (single.uphi0, single.ucp0, single.ucm0)
    for (_, ip, im) in dist.current_history:
        state = single.fused_step(*state)
        jp, jm = calc_ion_flux(single.ionflux_tables, *state)
        assert max(np.abs(ip - jp.numpy()).max(),
                   np.abs(im - jm.numpy()).max()) <= 1e-8
    uphi, _ = single.poisson_solve(*state)
    for got, want in zip((dist.phi, dist.cp, dist.cm),
                         (uphi, state[1], state[2])):
        assert np.abs(got - want.numpy()).max() <= 1e-8

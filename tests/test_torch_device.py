"""The port's entry points run on the card unless the caller asks for the
CPU: without ``device`` they resolve to the current CUDA device and raise
where there is none (no silent CPU run). The card side of this is in
tests/test_torch_cuda.py."""

import pytest
import torch

from pnp_tpu_torch import bench, entry
from pnp_tpu_torch.problems import one_wall_case, pore_case
from pnp_tpu_torch.utils.device import resolve_device
from pnp_tpu_torch.workloads.common import make_scalar_context
from pnp_tpu_torch.workloads import distributed_pnp as TD
from pnp_tpu_torch.workloads.distributed_pnp import (
    build_dist_pnp_system, run_distributed_pnp_from_pb)
from pnp_tpu_torch.workloads.instationary_pnp_from_pb import (
    build_pnp_system, run_instationary_pnp_from_pb)
from pnp_tpu_torch.workloads.instationary_pnp import run_instationary_pnp
from pnp_tpu_torch.workloads.pb import solve_pb
from pnp_tpu_torch.workloads.stationary_diffusion import (
    run_stationary_diffusion)
from pnp_tpu_torch.workloads.stationary_pnp import run_stationary_pnp

torch.set_num_threads(1)


def _dryrun(s, sp, **kw):
    """The multi-shard dry run on the (12, 7) pore, its large run forced
    onto two-level Schwarz at that size."""
    saved, TD.TWO_LEVEL_DOFS = TD.TWO_LEVEL_DOFS, 0
    try:
        return entry.dryrun_multichip(2, base=(12, 7), **kw)
    finally:
        TD.TWO_LEVEL_DOFS = saved


ENTRY_POINTS = {
    "run_instationary_pnp_from_pb":
        lambda s, sp, **kw: run_instationary_pnp_from_pb(s, sp, n_steps=1,
                                                         **kw),
    "build_pnp_system": build_pnp_system,
    "solve_pb": solve_pb,
    "make_scalar_context":
        lambda s, sp, **kw: make_scalar_context(s, sp, component=0,
                                                quad_order=3, **kw),
    # the other workloads, on the one-wall case (the monolithic Newton
    # solve does not converge under the pore case's bias)
    "run_stationary_diffusion":
        lambda s, sp, **kw: run_stationary_diffusion(*one_wall_case(10, 2),
                                                     **kw),
    "run_stationary_pnp":
        lambda s, sp, **kw: run_stationary_pnp(*one_wall_case(10, 2), **kw),
    "run_instationary_pnp":
        lambda s, sp, **kw: run_instationary_pnp(*one_wall_case(10, 2),
                                                 n_steps=2, **kw),
    # the owner-partitioned driver, 2 shards
    "run_distributed_pnp_from_pb":
        lambda s, sp, **kw: run_distributed_pnp_from_pb(s, sp, 2, n_steps=1,
                                                        **kw),
    "build_dist_pnp_system":
        lambda s, sp, **kw: build_dist_pnp_system(s, sp, 2, **kw),
    # the bench and the step entry, on their case at the (12, 7) base
    "bench.run_headline":
        lambda s, sp, **kw: bench.run_headline(1, base=(12, 7), **kw),
    "bench.run_scaled":
        lambda s, sp, **kw: bench.run_scaled(1, 1, base=(12, 7), **kw),
    "entry.entry": lambda s, sp, **kw: entry.entry(base=(12, 7), **kw),
    "entry.dryrun_multichip": _dryrun,
}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_default_device_raises_without_cuda(no_cuda, name):
    sys_, space = pore_case(12, 7)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](sys_, space)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_cpu_when_asked(no_cuda, name):
    sys_, space = pore_case(12, 7)
    out = ENTRY_POINTS[name](sys_, space, device="cpu")
    field = {"run_instationary_pnp_from_pb": lambda r: r.phi,
             "build_pnp_system": lambda r: r.pb,
             "solve_pb": lambda r: r.u,
             "make_scalar_context": lambda r: r.dirichlet,
             "run_stationary_diffusion": lambda r: r[0],
             "run_stationary_pnp": lambda r: r.u,
             "run_instationary_pnp": lambda r: r.phi,
             "run_distributed_pnp_from_pb": lambda r: r.system.uc0,
             "build_dist_pnp_system": lambda r: r.pb,
             "bench.run_headline": lambda r: r[1][0],
             "bench.run_scaled": lambda r: r[1][0],
             "entry.entry": lambda r: r[1][0],
             "entry.dryrun_multichip": lambda r: r["state"][0]}[name](out)
    assert field.device.type == "cpu" and bool(field.isfinite().all())


def test_resolve_device(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda:1")) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)

"""The port's command line, ``python -m pnp_tpu_torch``, on the CPU, and
the mesh readers behind it. Every run reads a Gmsh 2.2 file and a ``.cfg``
that the test writes into ``tmp_path`` from a ``rect_mesh`` one-wall case;
the readers (numpy parser, native meshkit bridge, uniform refinement) are
held to arrays identical to the reference package's on that file."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pnp_tpu.config as JC
from pnp_tpu.meshio import read_gmsh as j_read_gmsh
from pnp_tpu.meshio import native as JN
from pnp_tpu.meshio.refine import refine_uniform as j_refine

from pnp_tpu_torch import problems
from pnp_tpu_torch.cli import WORKLOADS, build_parser, main
from pnp_tpu_torch.config import read_config
from pnp_tpu_torch.meshio import read_gmsh
from pnp_tpu_torch.meshio import native as TN
from pnp_tpu_torch.meshio.refine import refine_uniform

from test_torch_host import assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A one-wall case written as ``one_wall.msh`` + ``one_wall.cfg``."""
    d = tmp_path_factory.mktemp("cli")
    tsys, tspace = problems.one_wall_case(20, 3)
    problems.write_gmsh(tspace.mesh, str(d / "one_wall.msh"))
    problems.write_config(tsys, str(d / "one_wall.cfg"), "one_wall.msh")
    return dict(dir=d, msh=str(d / "one_wall.msh"),
                cfg=str(d / "one_wall.cfg"), sys=tsys, space=tspace)


def run_cli(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "pnp_tpu_torch", *args],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


# ---- the files and their readers --------------------------------------------------

def test_written_files_read_back(files):
    """The written ``.msh`` and ``.cfg`` read back to the case they were
    written from, by the port's readers and by the reference's."""
    mesh = read_gmsh(files["msh"])
    assert_same(mesh, files["space"].mesh)
    assert_same(mesh, j_read_gmsh(files["msh"]))
    got = read_config(files["cfg"])
    assert got.meshfile == files["msh"]
    want = dataclasses.replace(files["sys"], meshfile=files["msh"])
    assert got == want
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JC.read_config(files["cfg"]))


def test_refine_uniform_is_a_copy(files):
    mesh = read_gmsh(files["msh"])
    for levels in (1, 2):
        got = refine_uniform(mesh, levels)
        assert_same(got, j_refine(j_read_gmsh(files["msh"]), levels))
        assert got.num_tris == 4 ** levels * mesh.num_tris
        got.validate()


def test_native_bridge_matches_python_parser(files):
    """The ctypes bridge to the port's own mesh kit (``csrc/meshkit.cpp``,
    built into ``pnp_tpu_torch/_build/``) gives the numpy parser's arrays,
    the reference bridge's arrays and its partition; where the library
    cannot be built or loaded, ``native_available()`` is False and
    ``read_gmsh_native`` raises."""
    assert TN.native_available() == JN.native_available()
    if not TN.native_available():
        with pytest.raises(RuntimeError, match="meshkit"):
            TN.read_gmsh_native(files["msh"])
        return
    assert TN._lib._name == str(TN.build())
    assert TN._lib._name.startswith(str(TN.BUILD_ROOT) + os.sep)
    assert_same(TN.read_gmsh_native(files["msh"]), read_gmsh(files["msh"]))
    assert_same(TN.read_gmsh_native(files["msh"]),
                JN.read_gmsh_native(files["msh"]))
    perm, off = TN.partition_elements(files["msh"], 4)
    jperm, joff = JN.partition_elements(files["msh"], 4)
    assert np.array_equal(perm, jperm) and np.array_equal(off, joff)
    E = files["space"].mesh.num_tris
    assert sorted(perm.tolist()) == list(range(E)) and off[-1] == E


def test_native_bridge_without_library(files, monkeypatch):
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_lib_failed", True)
    assert not TN.native_available()
    with pytest.raises(RuntimeError, match="meshkit"):
        TN.read_gmsh_native(files["msh"])
    with pytest.raises(RuntimeError, match="meshkit"):
        TN.partition_elements(files["msh"], 2)


# ---- the command line -----------------------------------------------------------

PROGRESS = {
    "pb": "PB Newton:",
    "stationary_diffusion": "linear solve:",
    "stationary_pnp": "PNP Newton:",
    "stationary_pnp_from_pb": "PNP Newton:",
    "instationary_pnp": "explicit run: 2 steps",
    "instationary_pnp_from_pb": "assembled-solved DOFs/s",
}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_workload_runs(files, workload, tmp_path):
    """``python -m pnp_tpu_torch --device cpu -w WORKLOAD``: exit code 0,
    the reference's progress lines under the port's name, and the output
    files of the workloads that write any."""
    out = tmp_path / "out"
    r = run_cli(["-w", workload, "--steps", "2", "-o", str(out),
                 "--device", "cpu", files["cfg"]])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[pnp_tpu_torch] mesh" in r.stdout and "84 nodes" in r.stdout
    assert PROGRESS[workload] in r.stdout
    assert "[pnp_tpu_torch] total wall" in r.stdout
    assert "device cpu" in r.stdout
    if workload == "stationary_diffusion":
        assert (out / "solution.dat.dat").exists()
        assert (out / "yeah.vtu").exists()
    if workload == "instationary_pnp_from_pb":
        rows = (out / "current.dat").read_text().strip().split("\n")
        assert len(rows) == 2
        assert (out / "data002.vtu").exists()


def test_solver_and_degree_flags(files):
    r = run_cli(["-w", "pb", "-s", "CG_Jacobi", "-p", "2", "--device", "cpu",
                 files["cfg"]])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "P2" in r.stdout and "PB Newton" in r.stdout


def test_checkpoint_resume_and_profile_flags(files, tmp_path):
    """``--checkpoint``/``--checkpoint-freq``/``--resume`` reach the
    production workload and ``--profile-dir`` writes a trace, in process."""
    ck = str(tmp_path / "ck.npz")
    common = ["--device", "cpu", "--checkpoint", ck, files["cfg"]]
    assert main(["--steps", "2", "--checkpoint-freq", "2", *common]) == 0
    assert os.path.exists(ck)
    prof = tmp_path / "prof"
    assert main(["--steps", "3", "--resume", "--profile-dir", str(prof),
                 "-o", str(tmp_path / "o"), *common]) == 0
    rows = (tmp_path / "o" / "current.dat").read_text().strip().split("\n")
    assert len(rows) == 1            # only step 3 ran after the resume
    assert (prof / "trace.json").exists()


def test_multi_device_flag_raises(files, tmp_path):
    """``-n 2 --device cpu`` runs the production workload on the
    owner-partitioned driver with 2 shards: its current.dat equals the
    library call's (1e-12); ``-n 0`` is refused."""
    from pnp_tpu_torch.fem.space import FunctionSpace
    from pnp_tpu_torch.workloads.distributed_pnp import \
        run_distributed_pnp_from_pb

    out = tmp_path / "cli"
    r = run_cli(["-n", "2", "--device", "cpu", "--steps", "2", "-o",
                 str(out), files["cfg"]])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "2 steps on 2 shards" in r.stdout
    cfg = read_config(files["cfg"])
    lib = run_distributed_pnp_from_pb(
        cfg, FunctionSpace(read_gmsh(cfg.meshfile), cfg.degree), 2,
        n_steps=2, output_dir=str(tmp_path / "lib"), device="cpu")
    assert lib.n_shards == 2
    got = np.loadtxt(out / "current.dat")
    want = np.loadtxt(tmp_path / "lib" / "current.dat")
    assert got.shape == want.shape == (2, 1 + 2 * cfg.n_surfaces)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError):
        main(["-n", "0", "--device", "cpu", files["cfg"]])


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the default resolves")
def test_no_card_and_no_device_flag_raises(files):
    """Without a card and without ``--device cpu`` the command fails with
    ``resolve_device``'s RuntimeError: it never goes to the CPU on its
    own."""
    r = run_cli(["-w", "pb", files["cfg"]])
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "no CUDA device" in r.stderr
    assert "PB Newton" not in r.stdout


def test_parser_has_the_reference_flags():
    from pnp_tpu.cli import build_parser as j_parser, WORKLOADS as j_workloads
    assert WORKLOADS == j_workloads
    ours = {a.dest: a for a in build_parser()._actions}
    for action in j_parser()._actions:
        assert action.dest in ours
        assert ours[action.dest].option_strings == action.option_strings
        assert ours[action.dest].default == action.default
    assert set(ours) - {a.dest for a in j_parser()._actions} == {"device"}

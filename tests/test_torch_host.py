"""The port's numpy host modules are copies of the reference's: pin them to
identical arrays, files and checkpoints (and the interop converters to
identical objects)."""

import dataclasses

import numpy as np
import pytest
import torch

import pnp_tpu.config as JC
import pnp_tpu.fem.constraints as JCON
import pnp_tpu.fem.quadrature as JQ
import pnp_tpu.fem.reference as JR
import pnp_tpu.fem.space as JS
import pnp_tpu.io.checkpoint as JCK
import pnp_tpu.io.writers as JW
import pnp_tpu.meshio.mesh as JM
import pnp_tpu.meshio.structured as JST
import pnp_tpu.timestepping.tableaux as JT

import pnp_tpu_torch.config as TC
import pnp_tpu_torch.fem.constraints as TCON
import pnp_tpu_torch.fem.quadrature as TQ
import pnp_tpu_torch.fem.reference as TR
import pnp_tpu_torch.fem.space as TS
import pnp_tpu_torch.io.checkpoint as TCK
import pnp_tpu_torch.io.writers as TW
import pnp_tpu_torch.meshio.mesh as TM
import pnp_tpu_torch.meshio.structured as TST
import pnp_tpu_torch.timestepping.tableaux as TT
from pnp_tpu_torch import interop, problems

torch.set_num_threads(1)

MESHES = {
    "rect": lambda m: m.rect_mesh(5, 4, 2.0, 1.0, y0=0.1),
    "pore": lambda m: m.pore_without_dna_mesh(30, 17),
}


def jax_sysparams(port_sys):
    """The reference package's Sysparams with the port's values."""
    d = dataclasses.asdict(port_sys)
    surfaces = [JC.Surface(**s) for s in d.pop("surfaces")]
    return JC.Sysparams(**d, surfaces=surfaces)


def assert_same(a, b):
    """Identical values (and shapes) for arrays, dataclasses and lists."""
    if dataclasses.is_dataclass(a):
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)]
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_config_copy(tmp_path):
    cfg = tmp_path / "case.cfg"
    cfg.write_text(
        "[mesh]\nfilename = pore.msh\n"
        "[system]\nn_surfaces = 2\ncylindrical = 1\nl_b = 0.7\n"
        "c0 = 0.06 # comment\ntau = 1.0\nlinearSolver = CG_Jacobi\n"
        "newtonReduction = 1e-9\n"
        "[surface_0]\ncoulombBtype = 0\ncoulombPotential = 24.1\n"
        "plusDiffusionBtype = 0\nplusDiffusionConcentration = 0.06\n"
        "[surface_1]\ncoulombFlux = 1.1\nminusDiffusionFlux = 0.5\n")
    assert_same(JC.read_config(str(cfg)), TC.read_config(str(cfg)))
    assert TC.LINEAR_SOLVERS == JC.LINEAR_SOLVERS
    assert (TC.DIRICHLET, TC.NEUMANN) == (JC.DIRICHLET, JC.NEUMANN)
    assert TC.Sysparams(compat_pi=True).pi == JC.Sysparams(compat_pi=True).pi


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_copy(name):
    a, b = MESHES[name](JST), MESHES[name](TST)
    assert_same(a, b)
    flipped = a.tris[:, [0, 2, 1]]
    assert_same(JM.fix_orientation(a.nodes, flipped),
                TM.fix_orientation(b.nodes, flipped))
    assert_same(JM.build_edge_adjacency(a.tris, a.edges),
                TM.build_edge_adjacency(b.tris, b.edges))


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_reference_copy(degree):
    pts = np.random.RandomState(degree).rand(7, 2) * 0.5
    a, b = JR.ReferenceTriangle(degree), TR.ReferenceTriangle(degree)
    assert_same(a.dof_ref_coords, b.dof_ref_coords)
    assert_same(a.values(pts), b.values(pts))
    assert_same(a.gradients(pts), b.gradients(pts))


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6, 7])
def test_quadrature_copy(order):
    assert_same(JQ.triangle_rule(order), TQ.triangle_rule(order))
    assert_same(JQ.interval_rule(order), TQ.interval_rule(order))


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_space_copy(degree):
    a = JS.FunctionSpace(JST.pore_without_dna_mesh(30, 17), degree)
    b = TS.FunctionSpace(TST.pore_without_dna_mesh(30, 17), degree)
    assert a.ndof == b.ndof
    for attr in ("dofmap", "dof_coords", "bedge_dofs"):
        assert_same(getattr(a, attr), getattr(b, attr))
    sel = a.mesh.edge_phys == 2
    assert_same(a.boundary_dof_mask(sel), b.boundary_dof_mask(sel))


@pytest.mark.parametrize("component", [0, 1, 2])
def test_constraints_copy(component):
    tsys, tspace = problems.pore_case(30, 17, degree=2)
    jsys = jax_sysparams(tsys)
    jspace = JS.FunctionSpace(JST.pore_without_dna_mesh(30, 17), 2)
    phi = np.random.RandomState(component).uniform(-1, 1, tspace.ndof)
    for fn in ("edge_btype", "flux_table", "neumann_flags"):
        assert_same(getattr(JCON, fn)(jsys, jspace.mesh),
                    getattr(TCON, fn)(tsys, tspace.mesh))
    for fn in ("dirichlet_dof_mask", "free_dof_mask", "dirichlet_dof_values"):
        assert_same(getattr(JCON, fn)(jspace, jsys, component),
                    getattr(TCON, fn)(tspace, tsys, component))
    assert_same(
        JCON.interpolate_with_pb_fallback(jspace, jsys, component, phi),
        TCON.interpolate_with_pb_fallback(tspace, tsys, component, phi))


@pytest.mark.parametrize("name", ["implicit_euler", "explicit_euler",
                                  "alexander2", "fractional_step_theta"])
def test_tableaux_copy(name):
    a, b = getattr(JT, name)(), getattr(TT, name)()
    assert (a.name, a.implicit, a.stages) == (b.name, b.implicit, b.stages)
    assert_same((a.A, a.B, a.D), (b.A, b.B, b.D))
    assert_same(JT.one_step_theta(0.3).B, TT.one_step_theta(0.3).B)


def test_writers_copy(tmp_path):
    jspace = JS.FunctionSpace(JST.pore_without_dna_mesh(30, 17), 1)
    tspace = TS.FunctionSpace(TST.pore_without_dna_mesh(30, 17), 1)
    rng = np.random.RandomState(0)
    phi, cp, cm = (rng.uniform(-1, 1, tspace.ndof) for _ in range(3))
    for tag, W, space in (("j", JW, jspace), ("t", TW, tspace)):
        W.write_dat(space, phi, str(tmp_path / f"{tag}.dat"))
        W.write_vtu(space, {"phi": phi, "cp": cp}, str(tmp_path / f"{tag}.vtu"))
        W.write_pnp_dat(space, phi, cp, cm, str(tmp_path / f"{tag}.pnp"))
        cw = W.CurrentWriter(str(tmp_path / f"{tag}.cur"))
        cw.write(1.0, phi[:6], cp[:6])
        cw.write(2.5, cm[:6], phi[:6])
        cw.close()
    for ext in ("dat", "vtu", "pnp", "cur"):
        assert (tmp_path / f"j.{ext}").read_bytes() == \
            (tmp_path / f"t.{ext}").read_bytes(), ext


def test_checkpoint_copy(tmp_path):
    tsys = problems.pore_sysparams()
    jsys = jax_sysparams(tsys)
    assert TCK.config_hash(tsys) == JCK.config_hash(jsys)
    rng = np.random.RandomState(1)
    phi, cp, cm = (rng.rand(11) for _ in range(3))
    TCK.save_checkpoint(str(tmp_path / "t.npz"), tsys, 4, 4.0, phi, cp, cm)
    JCK.save_checkpoint(str(tmp_path / "j.npz"), jsys, 4, 4.0, phi, cp, cm)
    a = JCK.load_checkpoint(str(tmp_path / "t.npz"), jsys)
    b = TCK.load_checkpoint(str(tmp_path / "j.npz"), tsys)
    assert a.keys() == b.keys()
    for k in a:
        assert_same(a[k], b[k])
    other = dataclasses.replace(tsys, tau=0.5)
    with pytest.raises(ValueError):
        TCK.load_checkpoint(str(tmp_path / "j.npz"), other)
    assert TCK.load_checkpoint(str(tmp_path / "none.npz"), tsys) is None


def test_interop_host_objects():
    tsys, tspace = problems.pore_case(30, 17, degree=2)
    jspace = JS.FunctionSpace(JST.pore_without_dna_mesh(30, 17), 2)
    assert_same(interop.sysparams(jax_sysparams(tsys)), tsys)
    assert_same(interop.mesh(jspace.mesh), tspace.mesh)
    ported = interop.function_space(jspace)
    assert ported.degree == 2 and ported.ndof == jspace.ndof
    assert_same(ported.dofmap, jspace.dofmap)
    phi, cp, cm = interop.state(*(np.arange(5.0) * k for k in (1, 2, 3)))
    assert phi.dtype == torch.float64 and float(cm[4]) == 12.0

"""The kernels' CUDA sources (``pnp_tpu_torch/csrc/gj_inverse.cu``,
``csrc/pb_element.cu``, ``csrc/element_spmv.cu``, ``csrc/cg_update.cu``;
not ``csrc/krylov_loop.cu``, which builds CUDA graphs) compiled as plain
C++ against
``csrc/emulation/cuda_runtime.h`` and run on the host: one std::thread per
CUDA thread, barriers for ``__syncthreads`` and the warp shuffles. This
checks the sources' index arithmetic, synchronisation, masking and scratch
layout against the plain PyTorch versions; what nvcc accepts, and every
time, is checked on the card (tests/test_torch_cuda.py, chip_smoke.py).
Needs g++ with C++20; skips without one."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pnp_tpu_torch.operators import kernels as K

torch.set_num_threads(1)


def host_library(tmp_path_factory, source, *defines):
    """One kernel source as a host library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    stem = source.split(".")[0]
    out = tmp_path_factory.mktemp(f"{stem}_emulation") / f"lib{stem}.so"
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
           "-x", "c++", *defines, "-I", str(K.CSRC / "emulation"),
           str(K.CSRC / source), "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0 and "c++20" in proc.stderr:
        pytest.skip("this g++ has no C++20")
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Kernel 1's source as a host library, bound like the real one."""
    return K._bind_gj(host_library(tmp_path_factory, "gj_inverse.cu",
                                   "-DGJ_HOST_EMULATION"))


@pytest.fixture(scope="module")
def emulated_pb(tmp_path_factory):
    """Kernel 2's source, every design compiled in, bound like the real
    one."""
    return K._bind_pb(host_library(tmp_path_factory, "pb_element.cu",
                                   "-DPB_HOST_EMULATION",
                                   "-DPB_ALL_DESIGNS"))


def run_emulated(lib, A, panel, variant, cluster=0):
    """``kernels._gj_core_cuda`` on numpy arrays; scratch and padding are
    filled with NaN so that any read of an unwritten value shows."""
    S, N, _ = A.shape
    ld = lib.gj_work_pitch(N)
    work = np.full((S, N, ld), np.nan, np.float32)
    work[:, :, :N] = A
    out = np.full((S, N, N), np.nan, np.float32)
    n_f32 = lib.gj_scratch_floats(S, N, panel, variant, cluster)
    n_i32 = lib.gj_scratch_ints(S, N, panel, variant, cluster)
    assert n_f32 > 0 and n_i32 > 0
    fscratch = np.full(n_f32, np.nan, np.float32)
    iscratch = np.full(n_i32, -(2 ** 30), np.int32)
    err = lib.gj_inverse_f32(work.ctypes.data, out.ctypes.data,
                             fscratch.ctypes.data, iscratch.ctypes.data,
                             S, N, panel, variant, cluster, None)
    assert err == 0
    return out, iscratch[:S * N].reshape(S, N)


def matrix(S, N, rows):
    rng = np.random.RandomState(N)
    A = (rng.rand(S, N, N).astype(np.float32) * 0.1
         + np.eye(N, dtype=np.float32)[None] * N * 0.05)
    if rows == "reversed":
        return A[:, ::-1].copy()
    if rows == "permuted":
        return A[:, rng.permutation(N)].copy()
    return A


# variant 0: one block a matrix; variant 1: the panel path, a launch a
# column; variant 2: the panel path, a cluster launch a panel, in clusters
# of `cluster` blocks (0: the plan's)
GJ_SOURCE_CASES = [
    (2, 40, 32, 0, 0, "permuted"),      # one full panel and a ragged one
    (1, 20, 32, 0, 0, "as made"),       # N below the panel width
    (1, 100, 16, 0, 0, "reversed"),     # pivots from the last rows
    (1, 20, 64, 1, 0, "as made"),
    (2, 40, 16, 1, 0, "permuted"),
    (1, 70, 32, 1, 0, "reversed"),      # three 32-row blocks, ragged panel
    (1, 20, 64, 2, 0, "as made"),       # N below one panel
    (2, 70, 32, 2, 2, "permuted"),      # a ragged last panel, 2 blocks
    (1, 100, 64, 2, 2, "reversed"),     # pivots from the other block
    (1, 130, 32, 2, 4, "reversed"),     # 4 blocks, ragged last panel
    (2, 90, 16, 2, 4, "permuted"),      # one block past the last row
]


def gj_case_id(case):
    S, N, panel, variant, cluster, rows = case
    if variant == 2:
        return f"{S}-{N}-{panel}-{variant}-cluster{cluster}-{rows}"
    return f"{S}-{N}-{panel}-{variant}-{rows}"


@pytest.mark.parametrize("S,N,panel,variant,cluster,rows", GJ_SOURCE_CASES,
                         ids=[gj_case_id(c) for c in GJ_SOURCE_CASES])
def test_gj_source_on_host_matches_plain(emulated, S, N, panel, variant,
                                         cluster, rows):
    """The same pivot rows as the plain version and the same inverse to f32
    round-off (1e-5 of its scale; the sums are rounded in another order);
    variant 2 equal to variant 1 on the same input, bit for bit."""
    A = matrix(S, N, rows)
    X, pivots = run_emulated(emulated, A, panel, variant, cluster)
    Xp, pivots_p = K._gj_core_plain(torch.tensor(A), panel)
    assert np.isfinite(X).all()
    assert np.array_equal(pivots, pivots_p.numpy())
    np.testing.assert_allclose(X, Xp.numpy(), rtol=0,
                               atol=1e-5 * float(Xp.abs().max()))
    if variant == 2:
        X1, pivots_1 = run_emulated(emulated, A, panel, 1)
        assert np.array_equal(pivots, pivots_1)
        assert np.array_equal(X.view(np.int32), X1.view(np.int32))
    if rows == "reversed":
        assert pivots[0, 0] == N - 1


def test_gj_source_rejects_bad_plans(emulated):
    """No kernel: the one-block variant above its largest order or panel,
    a panel-path width off the 4-column grid, an empty batch, a variant
    that does not exist; for the cluster panel also a cluster above 16
    blocks, one too small to hold its rows, and an order whose panel no
    cluster holds."""
    for S, N, panel, variant, cluster in (
            (1, K.SMALL_N_MAX + 1, 32, 0, 0), (1, 100, 64, 0, 0),
            (1, 100, 30, 1, 0), (1, 100, 128, 1, 0), (0, 100, 64, 1, 0),
            (1, 100, 0, 1, 0), (1, 100, 32, 3, 0), (1, 100, 30, 2, 0),
            (1, 100, 128, 2, 0), (0, 100, 64, 2, 0), (1, 100, 64, 2, 17),
            (1, 3105, 64, 2, 4), (1, 47745, 64, 2, 0), (1, 12097, 64, 2, 0)):
        assert emulated.gj_scratch_floats(S, N, panel, variant, cluster) == 0
        assert emulated.gj_scratch_ints(S, N, panel, variant, cluster) == 0


def test_gj_source_plans_the_cluster_path(emulated):
    """The wrapper's choice from the plan: one block a matrix up to
    SMALL_N_MAX, the cluster panel where a cluster's blocks hold the
    panel's rows (the dense stage batch at 3,105 and 4,801 nodes, the
    Schwarz batches), a launch a column above that (12,097 and the L2
    set-up's 47,745); the cluster panel's scratch no larger than the
    column path's."""
    for S, N, variant in ((96, 369, 0), (1484, 374, 0), (2, 3105, 2),
                          (2, 4801, 2), (8, 1685, 2), (16, 1685, 2),
                          (1, 12097, 1), (2, 12097, 1), (1, 47745, 1)):
        assert K.gj_variant(emulated, S, N) == variant, (S, N)
    for S, N in ((2, 3105), (2, 4801), (8, 1685)):
        for fn in (emulated.gj_scratch_floats, emulated.gj_scratch_ints):
            assert 0 < fn(S, N, K.PANEL, 2, 0) <= fn(S, N, K.PANEL, 1, 0)


# --- kernel 2: fused PB element residual + Jacobian -------------------------

NQ = {3: 4, 6: 6, 10: 12}        # quadrature points of P1-P3 on the path


def pb_tables(E, n, dtype, seed=0, u_scale=1.0):
    """Seeded tables of the kernel's shapes (no mesh: the kernel is
    elementwise), gradients and weights of the size a unit mesh gives."""
    rng = np.random.RandomState(seed)
    q = NQ[n]
    shape = rng.uniform(-0.2, 1.0, (q, n))
    gradphi = rng.uniform(-3.0, 3.0, (E, q, n, 2))
    qw = rng.uniform(0.01, 0.05, (E, q))
    qy = rng.uniform(0.1, 2.0, (E, q))
    ue = rng.uniform(-u_scale, u_scale, (E, n))
    return [torch.tensor(a, dtype=dtype)
            for a in (ue, shape, gradphi, qw, qy)]


def run_emulated_pb(lib, tensors, params, outputs, design):
    """``kernels.PBElement.__call__`` on host arrays, the outputs filled
    with NaN beforehand so that an element that is not written, or an
    output that should not be, shows."""
    ue, shape, gradphi, qw, qy = (t.numpy() for t in tensors)
    l_b, c0, cyl, pi = params
    E, n = ue.shape
    r = np.full((E, n), np.nan, ue.dtype)
    A = np.full((E, n, n), np.nan, ue.dtype)
    fn = lib.pb_element_f64 if ue.dtype == np.float64 else lib.pb_element_f32
    err = fn(ue.ctypes.data, shape.ctypes.data, gradphi.ctypes.data,
             qw.ctypes.data, qy.ctypes.data, r.ctypes.data, A.ctypes.data,
             E, shape.shape[0], n, 8.0 * pi * l_b * c0, int(cyl), 2.0 * pi,
             K.PB_OUTPUTS[outputs], *design, 0, None)
    assert err == 0
    return r, A


PB_PARAMS = (0.7, 0.06, True, np.pi)
SETTLED = K.PB_DESIGN


def check_pb_against_plain(lib, tensors, params, outputs, design, rtol):
    r, A = run_emulated_pb(lib, tensors, params, outputs, design)
    r_p, A_p = K.pb_residual_jacobian_plain(*tensors, *params,
                                            outputs=outputs)
    for got, want in ((r, r_p), (A, A_p)):
        if want is None:
            assert np.isnan(got).all()      # the other output: not touched
        else:
            want = want.numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("outputs", ["residual", "jacobian", "both"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n", [3, 6, 10])
def test_pb_source_on_host_matches_plain(emulated_pb, n, dtype, outputs):
    """The settled design at E = 1, 127, 128, 300 (one element, a ragged
    tail, whole blocks): equal to the plain version to round-off (f64
    1e-13, f32 1e-5 of the output's scale; the sums over quadrature points
    run in another order), and the output not asked for stays NaN."""
    rtol = 1e-13 if dtype == torch.float64 else 1e-5
    for E in (1, 127, 128, 300):
        check_pb_against_plain(emulated_pb, pb_tables(E, n, dtype, seed=E),
                               PB_PARAMS, outputs, SETTLED, rtol)


@pytest.mark.parametrize("design", [(1, 0, 128), (1, 1, 64), (4, 1, 128),
                                    (4, 0, 64), (4, 1, 256), (1, 1, 32)],
                         ids=lambda d: "tpe{}-staged{}-threads{}".format(*d))
def test_pb_source_every_design(emulated_pb, design):
    """The designs ``tools/pb_sweep.py`` times (threads an element, staging,
    threads a block), P1 and P3, f64 and f32, planar and cylindrical."""
    for n, dtype, E, cyl in ((3, torch.float64, 300, True),
                             (3, torch.float32, 131, False),
                             (10, torch.float64, 70, True),
                             (6, torch.float32, 37, True)):
        rtol = 1e-13 if dtype == torch.float64 else 1e-5
        params = PB_PARAMS[:2] + (cyl, np.pi)
        for outputs in ("residual", "jacobian", "both"):
            check_pb_against_plain(emulated_pb,
                                   pb_tables(E, n, dtype, seed=n + E),
                                   params, outputs, design, rtol)


def test_pb_source_one_exp_holds_over_u(emulated_pb):
    """sinh and cosh from one expm1 in the CUDA source: |u| from 1e-8 to 20
    (and u = 0), both signs, against torch's sinh and cosh through the
    volume forms' sums, to 1e-13 relative, entry by entry."""
    from pnp_tpu_torch.fem.geometry import VolumeTables
    from pnp_tpu_torch.operators import volume as V

    mags = np.concatenate([[0.0], np.logspace(-8, np.log10(20.0), 149)])
    E, n = 2 * mags.size, 3
    tensors = pb_tables(E, n, torch.float64, seed=7)
    # a constant u on each element: shape rows that sum to one
    tensors[1] = torch.tensor(np.full((NQ[n], n), 1.0 / n))
    tensors[0] = torch.tensor(np.concatenate([mags, -mags]))[:, None].repeat(
        1, n)
    # the sinh and cosh terms alone: no gradients
    tensors[2] = torch.zeros_like(tensors[2])
    r, A = run_emulated_pb(emulated_pb, tensors, PB_PARAMS, "both", SETTLED)
    t = VolumeTables(shape=tensors[1], gradphi=tensors[2], qw=tensors[3],
                     qy=tensors[4], dofmap=None)
    r_v = V.pb_residual_el(tensors[0], t, *PB_PARAMS).numpy()
    A_v = V.pb_jacobian_el(tensors[0], t, *PB_PARAMS).numpy()
    np.testing.assert_allclose(r, r_v, rtol=1e-13, atol=0)
    np.testing.assert_allclose(A, A_v, rtol=1e-13, atol=0)


def test_pb_source_rejects_bad_plans(emulated_pb):
    """No kernel: an order that is none of P1-P3, no output, a design that
    does not exist, a block that is no multiple of a warp or too large."""
    tensors = pb_tables(8, 3, torch.float64)
    ptrs = [t.numpy().ctypes.data for t in tensors]
    out = np.zeros(8 * 12)
    good = dict(n=3, outputs=3, tpe=4, staged=0, threads=128)
    for bad in (dict(n=4), dict(outputs=0), dict(outputs=4), dict(tpe=2),
                dict(threads=100), dict(threads=512), dict(threads=0)):
        a = {**good, **bad}
        err = emulated_pb.pb_element_f64(
            *ptrs, out.ctypes.data, out.ctypes.data, 8, 4, a["n"], 1.0, 0,
            6.28, a["outputs"], a["tpe"], a["staged"], a["threads"], 0, None)
        assert err != 0, bad


# --- kernel 3: constrained element-block SpMV -------------------------------

@pytest.fixture(scope="module")
def emulated_spmv(tmp_path_factory):
    """Kernel 3's source as a host library, bound like the real one."""
    return K._bind_spmv(host_library(tmp_path_factory, "element_spmv.cu",
                                     "-DSPMV_HOST_EMULATION"))


@pytest.fixture(scope="module", params=[1, 2, 3], ids=["P1", "P2", "P3"])
def pore_dofmap(request):
    """The structured pore's dof map at P1-P3 (488 nodes at P1), its dof
    count and the dofs' coordinates."""
    from pnp_tpu_torch.problems import pore_case

    _, space = pore_case(30, 17, degree=request.param)
    return (torch.as_tensor(np.asarray(space.dofmap, np.int64)), space.ndof,
            np.asarray(space.dof_coords))


def dirichlet_masks(dofmap, ndof, coords, S):
    """(S, ndof) masks: the bottom and top rows of dofs and a seeded tenth
    of the rest constrained; the dof of highest incidence free in system 0
    and constrained in system 1. Returns the masks and that dof."""
    rng = np.random.RandomState(ndof)
    y = coords[:, 1]
    wall = (y <= y.min() + 1e-12) | (y >= y.max() - 1e-12)
    free = ~(wall | (rng.rand(S, ndof) < 0.1))
    top = int(np.bincount(dofmap.reshape(-1).numpy(), minlength=ndof).argmax())
    free[:, top] = True
    if S > 1:
        free[1, top] = False
    return torch.as_tensor(free), top


def run_emulated_spmv(lib, A, x, dofmap, ndof, free):
    """``kernels.ElementSpmv`` on host arrays: blocks (S_A, E, n, n), S_A S
    or 1 (stride 0), x (S, ndof), free (S, ndof) or None; y filled with NaN
    beforehand, so that a row the kernel does not write shows."""
    S = x.shape[0]
    t = K.incidence_table(dofmap, ndof)
    A, x = A.contiguous().numpy(), x.contiguous().numpy()
    y = np.full((S, ndof), np.nan, x.dtype)
    mask = None if free is None else free.to(torch.uint8).numpy()
    fn = lib.element_spmv_f64 if x.dtype == np.float64 else lib.element_spmv_f32
    E, n = dofmap.shape
    err = fn(A.ctypes.data, E * n * n if A.shape[0] > 1 else 0,
             x.ctypes.data, None if mask is None else mask.ctypes.data,
             y.ctypes.data, t.dofmap.numpy().ctypes.data,
             t.offsets.numpy().ctypes.data, t.entries.numpy().ctypes.data, S,
             ndof, n, 0, None)
    assert err == 0
    return torch.as_tensor(y)


SPMV_FORMS = ["one system", "per-system blocks", "shared blocks",
              "unconstrained"]


@pytest.mark.parametrize("form", SPMV_FORMS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_spmv_source_on_host_matches_plain(emulated_spmv, pore_dofmap,
                                           dtype, form):
    """Kernel 3 against ``fem/assembly.py``'s plain version on the pore's
    P1-P3 dof maps: one system under its mask (the constrained operator),
    two systems with their own blocks and masks (the species pair), two
    systems sharing one set of blocks (the mass matrix), and the
    unconstrained product. Every row written, constrained rows exactly x,
    the rest to round-off (f64 1e-13, f32 1e-5 of the output's scale), the
    dof of highest incidence among them."""
    from pnp_tpu_torch.fem import assembly as FA

    dofmap, ndof, coords = pore_dofmap
    E, n = dofmap.shape
    S = 1 if form == "one system" else 2
    rng = np.random.RandomState(n + S)
    A = torch.tensor(rng.standard_normal((S, E, n, n)), dtype=dtype)
    x = torch.tensor(rng.standard_normal((S, ndof)), dtype=dtype)
    free, top = dirichlet_masks(dofmap, ndof, coords, S)
    if form == "one system":
        y = run_emulated_spmv(emulated_spmv, A, x, dofmap, ndof, free)[0]
        want = FA.make_constrained_operator(A[0], dofmap, ndof, free[0])(x[0])
        free = free[0]
    elif form == "per-system blocks":
        y = run_emulated_spmv(emulated_spmv, A, x, dofmap, ndof, free)
        want = FA.make_constrained_operator(A, dofmap, ndof, free)(x)
    elif form == "shared blocks":
        y = run_emulated_spmv(emulated_spmv, A[:1], x, dofmap, ndof, None)
        want = FA.spmv_batched(A[:1], x, dofmap, ndof)
        free = None
    else:
        y = run_emulated_spmv(emulated_spmv, A, x, dofmap, ndof, None)
        want = FA.spmv_batched(A, x, dofmap, ndof)
        free = None
    assert not torch.isnan(y).any()
    if free is not None:
        assert torch.equal(y[~free], x.reshape(y.shape)[~free])
        assert bool(free[..., top].reshape(-1)[0])
    rtol = 1e-13 if dtype == torch.float64 else 1e-5
    scale = float(want.abs().max())
    torch.testing.assert_close(y, want, rtol=0, atol=rtol * scale)
    torch.testing.assert_close(y[..., top], want[..., top], rtol=0,
                               atol=rtol * scale)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_spmv_source_any_order(emulated_spmv, dtype):
    """An order that is none of P1-P3 takes the kernel with n at run time:
    the monolithic Newton's composite (E, 9) blocks on 3 x 488 dofs."""
    from pnp_tpu_torch.fem import assembly as FA
    from pnp_tpu_torch.operators.pnp import composite_dofmap
    from pnp_tpu_torch.problems import pore_case

    _, space = pore_case(30, 17)
    dofmap = composite_dofmap(torch.as_tensor(np.asarray(space.dofmap,
                                                         np.int64)),
                              space.ndof)
    ndof = 3 * space.ndof
    E, n = dofmap.shape
    rng = np.random.RandomState(9)
    A = torch.tensor(rng.standard_normal((1, E, n, n)), dtype=dtype)
    x = torch.tensor(rng.standard_normal((1, ndof)), dtype=dtype)
    free = torch.as_tensor(rng.rand(1, ndof) > 0.2)
    y = run_emulated_spmv(emulated_spmv, A, x, dofmap, ndof, free)[0]
    want = FA.make_constrained_operator(A[0], dofmap, ndof, free[0])(x[0])
    rtol = 1e-13 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(y, want, rtol=0,
                               atol=rtol * float(want.abs().max()))


def test_incidence_table_lists_every_block_row_once(pore_dofmap):
    """Every (e, l) once; each dof's entries sorted by element and all of
    that dof; the offsets the running count of each dof's incidences."""
    dofmap, ndof, _ = pore_dofmap
    E, n = dofmap.shape
    t = K.incidence_table(dofmap, ndof)
    entries, offsets = t.entries.long(), t.offsets.long()
    assert t.dofmap.dtype == t.offsets.dtype == t.entries.dtype == torch.int32
    assert torch.equal(t.dofmap.long(), dofmap)
    assert torch.equal(torch.sort(entries).values, torch.arange(E * n))
    counts = torch.bincount(dofmap.reshape(-1), minlength=ndof)
    assert int(offsets[0]) == 0 and int(offsets[-1]) == E * n
    assert torch.equal(offsets.diff(), counts)
    row = torch.repeat_interleave(torch.arange(ndof), counts)
    assert torch.equal(dofmap.reshape(-1)[entries], row)
    # within a row: increasing flat index, so increasing element
    step = entries.diff()
    assert bool((step[row[1:] == row[:-1]] > 0).all())


def test_spmv_source_rejects_bad_plans(emulated_spmv):
    """No kernel: no order, no system, more systems than grid.y holds."""
    dofmap = torch.tensor([[0, 1, 2]])
    t = K.incidence_table(dofmap, 3)
    A, x, y = np.ones(9), np.ones(3), np.zeros(3)
    ptrs = [p.numpy().ctypes.data for p in (t.dofmap, t.offsets, t.entries)]
    for S, n in ((1, 0), (0, 3), (65536, 3)):
        err = emulated_spmv.element_spmv_f64(
            A.ctypes.data, 0, x.ctypes.data, None, y.ctypes.data, *ptrs, S,
            3, n, 0, None)
        assert err != 0, (S, n)


# --- the CG iteration's updates and flag ------------------------------------

@pytest.fixture(scope="module")
def emulated_cg(tmp_path_factory):
    """``csrc/cg_update.cu`` as a host library, bound like the real one."""
    return K._bind_cg(host_library(tmp_path_factory, "cg_update.cu",
                                   "-DCG_HOST_EMULATION"))


def _ptr(t):
    return t.data_ptr()


@pytest.mark.parametrize("rows", [1, 2])
def test_cg_updates_give_the_torch_operations_bits(emulated_cg, rows):
    """The source's cg_update, cg_direction and krylov_unconverged against
    the torch operations they replace (``kernels.*_plain``), bit for bit,
    over 300 values a row (a ragged second block), with a zero where a
    divisor is taken (the 1 it stands for) and the flag both ways."""
    n = 300
    g = torch.Generator().manual_seed(rows)

    def vec():
        return torch.randn((rows, n), generator=g, dtype=torch.float64)

    def scal():
        return torch.randn((rows, 1), generator=g, dtype=torch.float64)

    x, r, p, Ap, z = vec(), vec(), vec(), vec(), vec()
    pAp, rz, rz_new = scal(), scal(), scal()
    pAp[0], rz[-1] = 0.0, 0.0
    want = [v.clone() for v in (x, r, p)]
    K.cg_update_plain(want[0], want[1], p, Ap, pAp, rz)
    assert emulated_cg.cg_update_f64(
        _ptr(x), _ptr(r), _ptr(p), _ptr(Ap), _ptr(pAp), _ptr(rz), rows, n, 0,
        None) == 0
    assert torch.equal(x, want[0]) and torch.equal(r, want[1])
    K.cg_direction_plain(want[2], z, rz_new, rz)
    assert emulated_cg.cg_direction_f64(
        _ptr(p), _ptr(z), _ptr(rz_new), _ptr(rz), rows, n, 0, None) == 0
    assert torch.equal(p, want[2])
    ss = (r.double() ** 2).sum(-1, keepdim=True)
    for scale in (0.5, 2.0):
        tol = torch.sqrt(ss) * scale
        tol[0] = torch.sqrt(ss[0])               # equal: not above
        flag = torch.zeros((), dtype=torch.bool)
        assert emulated_cg.krylov_unconverged_f64(
            _ptr(ss), _ptr(tol), _ptr(flag), rows, 0, None) == 0
        assert bool(flag) == bool(K.krylov_unconverged_plain(ss, tol)) \
            == (scale < 1.0 and rows > 1)

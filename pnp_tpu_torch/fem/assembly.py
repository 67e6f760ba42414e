"""Batched global assembly: gather -> element kernel -> scatter-add.

Port of ``pnp_tpu.fem.assembly``: element dof values are gathered as one
(E, ndof_el) tensor, element residuals/Jacobians are dense batched
contractions, and global sums are one ``index_add_`` (XLA's ``.at[].add``).
Jacobians stay unassembled as per-element blocks and are applied
matrix-free (gather -> batched matvec -> scatter). Dirichlet constraints
are boolean dof masks: constrained residual rows are zeroed and the
constrained operator acts as identity on constrained dofs.

On CUDA, ``index_add_`` and accumulating ``index_put_`` sum with atomics
in an order that changes from run to run, so sums vary in the last bits
between runs; every tolerance that reads them says so.

Element-sharded tables (:mod:`..parallel.sharding`) carry their dof map as
a :class:`~..parallel.sharding.ShardedDofmap`: :func:`scatter_add` and
:func:`scatter_add_batched`, the scatters every assembly and SpMV here goes
through, hand it the values, and it sums the shards' partial vectors (the
psum GSPMD inserted in the reference). Any other dof map takes the plain
``index_add_``.
"""

from __future__ import annotations

import torch

from ..parallel.sharding import ShardedDofmap


def gather(u, dofmap):
    """u (ndof,) -> element dof values (E, ndof_el)."""
    return u[dofmap]


def scatter_add(values, dofmap, ndof: int):
    """Accumulate per-element values (E, ndof_el) into a global (ndof,) vector."""
    if isinstance(dofmap, ShardedDofmap):
        return dofmap.scatter(values, ndof)
    out = torch.zeros(ndof, dtype=values.dtype, device=values.device)
    return out.index_add_(0, dofmap.reshape(-1), values.reshape(-1))


def scatter_add_batched(values, dofmap, ndof: int):
    """Batched :func:`scatter_add`: values (S, E, ndof_el) -> (S, ndof)."""
    if isinstance(dofmap, ShardedDofmap):
        return dofmap.scatter(values, ndof)
    out = torch.zeros((values.shape[0], ndof), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(1, dofmap.reshape(-1),
                          values.reshape(values.shape[0], -1))


def spmv(A_el, x, dofmap, ndof: int):
    """Matrix-free SpMV from per-element dense blocks.

    A_el: (E, n, n); x: (ndof,). Returns A @ x as (ndof,).
    """
    ye = torch.einsum("eij,ej->ei", A_el, x[dofmap])
    return scatter_add(ye, dofmap, ndof)


def spmv_batched(A_el, x, dofmap, ndof: int):
    """Batched matrix-free SpMV: A_el (S, E, n, n), x (S, ndof)."""
    ye = torch.einsum("seij,sej->sei", A_el, x[:, dofmap])
    return scatter_add_batched(ye, dofmap, ndof)


def make_constrained_operator_batched(A_el, dofmap, ndof: int, free):
    """Batched variant of make_constrained_operator: free is (S, ndof)."""

    def op(x):
        y = spmv_batched(A_el, torch.where(free, x, 0.0), dofmap, ndof)
        return torch.where(free, y, x)

    return op


def diagonal(A_el, dofmap, ndof: int):
    """Global matrix diagonal from element blocks."""
    return scatter_add(torch.diagonal(A_el, dim1=-2, dim2=-1), dofmap, ndof)


def constrain_residual(r, free):
    """Zero residual entries on constrained (Dirichlet) dofs."""
    return torch.where(free, r, 0.0)


def make_constrained_operator(A_el, dofmap, ndof: int, free):
    """Return y = A_c @ x where A_c is A with Dirichlet rows/cols replaced by
    identity: y_c = x_c on constrained dofs, couplings masked out."""

    def op(x):
        y = spmv(A_el, torch.where(free, x, 0.0), dofmap, ndof)
        return torch.where(free, y, x)

    return op


def constrained_diagonal(A_el, dofmap, ndof: int, free):
    return torch.where(free, diagonal(A_el, dofmap, ndof), 1.0)


def dense_constrained_matrix_batched(A_el, dofmap, ndof: int, free):
    """Batched dense assembly: A_el (S, E, n, n), free (S, ndof) ->
    (S, ndof, ndof) with Dirichlet identity rows/cols per system."""
    S, E, n, _ = A_el.shape
    dev = A_el.device
    A = torch.zeros((S, ndof, ndof), dtype=A_el.dtype, device=dev)
    s_idx = torch.arange(S, device=dev)[:, None, None, None].expand(S, E, n, n)
    rows = dofmap[None, :, :, None].expand(S, E, n, n)
    cols = dofmap[None, :, None, :].expand(S, E, n, n)
    A.index_put_((s_idx, rows, cols), A_el, accumulate=True)
    f = free.to(A.dtype)
    A = A * f[:, :, None] * f[:, None, :]
    return A + torch.diag_embed(1.0 - f)


def dense_constrained_matrix(A_el, dofmap, ndof: int, free):
    """Assemble the full (ndof, ndof) matrix with Dirichlet identity rows.

    For constant operators on meshes small enough for the dense tier;
    memory is ndof^2 * 8 bytes — the caller gates on size.
    """
    return dense_constrained_matrix_batched(A_el[None], dofmap, ndof,
                                            free[None])[0]

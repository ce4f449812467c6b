"""Device-mesh parallelism for MCA solves and Monte-Carlo ensembles, on
``torch.distributed``.

Counterpart of ``xmca_tpu/parallel/mesh.py``.  The JAX package's mesh is
one process driving every device, with XLA's SPMD partitioner inserting
the collectives; here every device has its own process (launch with
``torchrun --nproc-per-node=K``), each process runs the same script and
gets the same results back.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX axis names:

* ``'space'``: the flattened grid axis of the fields.  Each rank holds a
  contiguous block of every field's packed columns (and so the same rows
  of the singular vectors); a contraction over space (a temporal Gram, a
  rotation criterion, the raw scores ``X V``) is the rank's partial plus
  an ``all_reduce`` over the space group, and everything without a space
  axis (the n x n algebra, U, the spectra, the totals) is replicated:
  every rank computes it from identical inputs.
* ``'ensemble'``: Monte-Carlo runs.  Rank ``e`` of the axis runs a
  contiguous share of the run seeds, and the runs are gathered in run
  order; the ranks of one space group run the same runs.

Every collective is an ``all_reduce`` (a sum, a max or a min), which
NCCL and gloo both run on CUDA tensors, so a mesh of several ranks can
share one card over gloo.  A gather is zeros, plus the rank's own block,
plus a sum (exact: x + 0 == x).  An axis of size 1 communicates nothing.
Every collective is counted, with its bytes, in the ``collectives`` and
``collective_bytes`` counters of :mod:`xmca_tpu_torch.utils.trace`, as
kernel launches are; :func:`collective_counts` reads them.

The space contractions read the mesh from :func:`space_context`, which
the model's methods enter around work on sharded data; outside it (and
always for Rule-N, whose surrogate fields are whole on every rank) they
are the plain single-device products.
"""
import contextlib
import os

import torch
import torch.distributed as dist

from xmca_tpu_torch.utils import trace

__all__ = ['ENSEMBLE_AXIS', 'SPACE_AXIS', 'make_mesh',
           'distribute_array', 'sharded_solve', 'axis_size', 'axis_rank',
           'space_context', 'reset_collective_counts',
           'collective_counts']

ENSEMBLE_AXIS = 'ensemble'
SPACE_AXIS = 'space'

_OPS = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX,
        'min': dist.ReduceOp.MIN}
_ACTIVE = {'mesh': None}


def reset_collective_counts():
    trace.reset_counters('collectives', 'collective_bytes')


def collective_counts():
    """``{'all_reduce': collectives run, 'bytes': bytes they reduced}``,
    or ``{}`` before the first."""
    out = trace.counts('collectives')
    if out:
        out['bytes'] = sum(trace.counts('collective_bytes').values())
    return out


def make_mesh(ensemble=1, space=1, devices=None, device_type='cuda'):
    """A 2-D ('ensemble', 'space') ``DeviceMesh`` over the ranks of the
    process group.

    ``ensemble * space`` must be the world size.  ``devices``: the ranks
    to lay out (default: all of them, in order).  ``device_type``:
    'cuda' (default; each rank's current device, NCCL or gloo) or 'cpu'
    (gloo).  On a card, a process group not yet initialized is
    initialized from ``torchrun``'s environment (NCCL, each rank on
    device ``LOCAL_RANK``); a CPU mesh needs the caller's own
    ``init_process_group(backend='gloo', ...)``.  A mesh on 'cuda'
    without a card raises; nothing falls back to the CPU.
    """
    if device_type not in ('cuda', 'cpu'):
        raise ValueError("device_type must be 'cuda' or 'cpu'")
    if device_type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh(device_type='cuda') needs a CUDA device, and "
            "torch.cuda.is_available() is False; a CPU mesh takes "
            "device_type='cpu' and a gloo process group")
    if not dist.is_initialized():
        if device_type != 'cuda':
            raise RuntimeError(
                'make_mesh: initialize the process group first, e.g. '
                "torch.distributed.init_process_group(backend='gloo', "
                'init_method=..., world_size=..., rank=...)')
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0))
                              % torch.cuda.device_count())
        dist.init_process_group('nccl')
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    n = ensemble * space
    if n > len(ranks):
        raise ValueError(
            'mesh needs {} devices but only {} are available'
            .format(n, len(ranks)))
    if n != dist.get_world_size():
        raise ValueError(
            'a mesh spans the whole process group: {} ranks for a world '
            'of {}'.format(n, dist.get_world_size()))
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type,
                      torch.tensor(ranks[:n]).reshape(ensemble, space),
                      mesh_dim_names=(ENSEMBLE_AXIS, SPACE_AXIS))


def axis_size(mesh, axis):
    """Shard count of ``axis`` (1 without a mesh); a name that is not an
    axis of the mesh raises ``ValueError``."""
    if mesh is None:
        return 1
    if axis not in mesh.mesh_dim_names:
        raise ValueError('{!r} is not an axis of the mesh {}'.format(
            axis, mesh.mesh_dim_names))
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis):
    """This rank's coordinate along ``axis`` (0 without one)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def mesh_device(mesh):
    """The device this rank's tensors live on."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def all_reduce(x, mesh, axis, op='sum'):
    """``x`` reduced over ``axis`` (a fresh tensor the caller gives up: it
    is reduced in place when contiguous); ``x`` itself on an axis of
    size 1."""
    if axis_size(mesh, axis) == 1:
        return x
    x = x.resolve_conj().contiguous()
    dist.all_reduce(x, op=_OPS[op], group=mesh.get_group(axis))
    trace.count('collectives', 'all_reduce')
    trace.count('collective_bytes', 'all_reduce', x.numel() * x.element_size())
    return x


def all_reduce_many(tensors, mesh, axis):
    """Sum several fresh tensors over ``axis`` in ONE collective (their
    real views side by side); returns them in order."""
    if axis_size(mesh, axis) == 1:
        return list(tensors)
    views = [torch.view_as_real(t.resolve_conj()) if t.is_complex() else t
             for t in tensors]
    flat = all_reduce(torch.cat([v.reshape(-1) for v in views]), mesh, axis)
    out, pos = [], 0
    for t, v in zip(tensors, views):
        part = flat[pos:pos + v.numel()].reshape(v.shape)
        pos += v.numel()
        out.append(torch.view_as_complex(part) if t.is_complex() else part)
    return out


def barrier(mesh):
    """Every rank of ``mesh`` waits for the others (a one-element sum
    over the whole mesh)."""
    if mesh is None or mesh.size() == 1:
        return
    x = torch.zeros(1, device=mesh_device(mesh))
    dist.all_reduce(x)
    trace.count('collectives', 'all_reduce')
    trace.count('collective_bytes', 'all_reduce', x.element_size())


def is_writer(mesh):
    """True on the one rank that writes files for the mesh."""
    return mesh is None or dist.get_rank() == 0


# ------------------------------------------------------------ the ensemble
def ensemble_map(rows_of, items, mesh, axis=ENSEMBLE_AXIS):
    """``rows_of(items)``: a list of 1-D tensors, one row an item.  On an
    ``axis`` of more than one shard each rank calls ``rows_of`` on its
    contiguous share of ``items`` (``ceil(len / shards)`` of them; the
    last shares may be short or empty) and every rank gets all the rows
    back, in item order, as one float64 ``(len(items), w)`` tensor (each
    rank's values upcast exactly)."""
    shards = axis_size(mesh, axis)
    if shards == 1:
        return rows_of(items)
    n = len(items)
    per = -(-n // shards)
    lo = min(axis_rank(mesh, axis) * per, n)
    rows = rows_of(items[lo:lo + per]) if lo < n else []
    device = mesh_device(mesh)
    w = torch.tensor([rows[0].numel() if rows else 0], device=device)
    w = int(all_reduce(w, mesh, axis, op='max'))
    buf = torch.zeros((n, w), dtype=torch.float64, device=device)
    if rows:
        buf[lo:lo + len(rows)] = torch.stack(
            [r.to(device=device, dtype=torch.float64) for r in rows])
    return all_reduce(buf, mesh, axis)


# --------------------------------------------------------------- the space
@contextlib.contextmanager
def space_context(mesh):
    """Within it, the space contractions of ``core`` (Grams, rotation
    criteria, column norms, field decompositions) sum over ``mesh``'s
    'space' axis; a mesh without one, or None, makes them local."""
    prev = _ACTIVE['mesh']
    _ACTIVE['mesh'] = mesh if axis_size(mesh, SPACE_AXIS) > 1 else None
    try:
        yield
    finally:
        _ACTIVE['mesh'] = prev


def space_sharded():
    """True inside a :func:`space_context` of more than one shard."""
    return _ACTIVE['mesh'] is not None


def space_sum(x):
    """The sum of ``x`` over the space shards (``x`` outside a
    context)."""
    mesh = _ACTIVE['mesh']
    return x if mesh is None else all_reduce(x, mesh, SPACE_AXIS)


def space_max(x):
    """The elementwise maximum of ``x`` over the space shards."""
    mesh = _ACTIVE['mesh']
    return x if mesh is None else all_reduce(x, mesh, SPACE_AXIS, op='max')


def space_all(flag, device):
    """A host bool that is True on every rank only where it is on all."""
    mesh = _ACTIVE['mesh']
    if mesh is None:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], device=device)
    return bool(all_reduce(t, mesh, SPACE_AXIS, op='min'))


def space_total(n, device):
    """The sum of the per-rank count ``n`` over the space shards (a row
    or column count; ``n`` outside a context)."""
    mesh = _ACTIVE['mesh']
    if mesh is None:
        return n
    t = torch.tensor([int(n)], device=device)
    return int(all_reduce(t, mesh, SPACE_AXIS))


def col_norm(x):
    """Per-column 2-norms of ``x`` whose rows are sharded over space
    (``torch.linalg.norm(x, dim=0)`` outside a context)."""
    if not space_sharded():
        return torch.linalg.norm(x, dim=0)
    sq = torch.sum((x * x.conj()).real, dim=0)
    return torch.sqrt(space_sum(sq))


def space_offsets(widths, device):
    """``(lo, total)``: for each of several column blocks this rank holds
    (their widths ``widths``; one block a field), where the rank's block
    starts in the field's columns and the field's whole width, from ONE
    collective (``(0, widths)`` outside a context)."""
    mesh = _ACTIVE['mesh']
    if mesh is None:
        return [0] * len(widths), [int(w) for w in widths]
    shards, r = axis_size(mesh, SPACE_AXIS), axis_rank(mesh, SPACE_AXIS)
    t = torch.zeros((shards, len(widths)), dtype=torch.int64, device=device)
    t[r] = torch.as_tensor([int(w) for w in widths], device=device)
    t = all_reduce(t, mesh, SPACE_AXIS).cpu()
    return t[:r].sum(dim=0).tolist(), t.sum(dim=0).tolist()


def draws_on_rank(own, total):
    """The map from draws (a LongTensor of indices into an axis of
    ``total``, repeats allowed) to those that fall on this rank's
    entries, given as their positions ``own`` (a LongTensor) along that
    axis: each kept draw becomes its entry's index in ``own``, in draw
    order with its repeats."""
    g2l = torch.full((total,), -1, dtype=torch.long, device=own.device)
    g2l[own] = torch.arange(len(own), device=own.device)

    def local(idx):
        loc = g2l[idx]
        return loc[loc >= 0]
    return local


def space_gather_cols(X):
    """``(full, lo)``: the columns of every space shard of ``X`` side by
    side in rank order, and where this rank's block starts."""
    mesh = _ACTIVE['mesh']
    (lo,), (total,) = space_offsets([X.shape[1]], X.device)
    full = torch.zeros((X.shape[0], total), dtype=X.dtype, device=X.device)
    full[:, lo:lo + X.shape[1]] = X
    return all_reduce(full, mesh, SPACE_AXIS), lo


def gather_rows(x, cols, total, mesh):
    """The full ``(total, ...)`` stack of a tensor whose rows are sharded
    over ``mesh``'s space axis, this rank's rows at the global positions
    ``cols`` (host ints); ``x`` itself when ``cols`` is None."""
    if cols is None:
        return x
    full = torch.zeros((total,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    full[torch.as_tensor(cols, device=x.device)] = x
    return all_reduce(full, mesh, SPACE_AXIS)


# -------------------------------------------------------------- public API
def distribute_array(x, mesh, axis=1, mesh_axis=SPACE_AXIS):
    """This rank's shard of ``x`` (a tensor or an ndarray): the
    contiguous block of dimension ``axis`` that rank holds along
    ``mesh_axis``.  The dimension must divide by the shard count
    (``ValueError`` otherwise, as the JAX package's placement raises)."""
    shards = axis_size(mesh, mesh_axis)
    size = x.shape[axis]
    if size % shards:
        raise ValueError(
            'dimension {} of size {} does not divide over the {} shards '
            'of mesh axis {!r}'.format(axis, size, shards, mesh_axis))
    w = size // shards
    lo = axis_rank(mesh, mesh_axis) * w
    index = [slice(None)] * x.ndim
    index[axis] = slice(lo, lo + w)
    return x[tuple(index)]


def sharded_solve(Xl, Xr=None, mesh=None, method='gram'):
    """The exact MCA (PCA without ``Xr``) solve with the fields' columns
    sharded over ``mesh``'s 'space' axis: every rank passes the whole
    centered fields and keeps its block; the temporal Grams are per-rank
    partials plus a sum, the small eigh/SVD is replicated.

    Returns ``(singular_values, V_left, V_right_or_None)``, the ``V`` the
    rank's rows (the same block of rows as its columns).
    """
    from xmca_tpu_torch.core import solver as _solver
    if mesh is None:
        raise ValueError('mesh is required')
    device = mesh_device(mesh)
    Xl = distribute_array(torch.as_tensor(Xl, device=device), mesh)
    with space_context(mesh):
        if Xr is None:
            s, V = _solver.solve_pca(Xl, method=method)
            return s, V, None
        Xr = distribute_array(torch.as_tensor(Xr, device=device), mesh)
        return _solver.solve_mca(Xl, Xr, method=method)

"""Bootstrapping of chunk-backed (out-of-core) models, in Gram space.

Counterpart of ``xmca_tpu/stats/streaming_boot.py``.  A chunk-backed
model's data never sits whole on the device, so its bootstrap cannot
resample the data; it resamples the Grams the streamed solve stored.
The in-memory bootstrap
(:func:`xmca_tpu_torch.stats.significance.bootstrap_spectra`) runs the
same time-axis run (``significance._time_resample_runs``) on Grams it
forms once a call; what stays this module's own is the streaming: the
stored Grams, the batched projection passes, the counts passes of a
column resample and the mode-space deflation.

**Time axis (axis=0).**  A moving-block row draw ``P`` (indices ``idx``)
resamples the centered field to ``A = C P Xc`` (``C`` re-centers), whose
temporal Gram is index algebra on the stored one::

    A A^T = C G[idx][:, idx] C          (no pass over the data)

Then the analytic fold (complexified), the jitter at the kept width,
Cholesky on each side and the subspace SVD of ``M = La^H Lb / dof``
through the two factors (``M`` is never formed): an unrotated run reads
no data at all.  A rotated run also needs the
resample's spatial loadings, ``V = A^T Z = Xc^T (P^T C Z)`` with ``Z``
the real recovery stack: the weights ``Y = P^T C Z`` (each duplicated
draw adds its row, ``index_add_``) of every run of a batch go through ONE
projection pass per field.

**Space axis (axis=1).**  A run's column draw becomes its column counts
``c_r`` over the full column layout, and ONE pass over the resampled
field(s) accumulates every run's ``G_r = Xd diag(c_r) Xd^T`` (the runs'
counts of both sides stack into that pass when both fields are
resampled).  A side that is not resampled keeps its original Cholesky.
Rotated runs add one projection pass over the resampled field(s), whose
rows each run gathers, and one over a bivariate model's other field.

**Iterative (Winkler) deflation** stays in mode space: with the rank-k
reconstruction ``Rec = real(S W^H)`` of the leading modes,
``G_defl = G - B - B^T + S_st (W_st^T W_st) S_st^T`` with
``B = (Xc W)_st S_st^T`` (:func:`deflated_gram`; ``_st`` stacks the real
and imaginary parts side by side), a counts pass deflates each chunk as
it goes (``cc - S_st W_rows^T``) and a projection pass subtracts
``W_rows (S_st^T Y)``.

Each run draws its block indices, then its subspace start block, from a
CPU ``torch.Generator`` seeded with its run seed, as ``bootstrap_spectra``
does: a chunk-backed model and an in-memory model of the same data
resample alike, run for run, on the card and on the CPU.  The runs of a
batch are solved and rotated one after another; what a batch shares is
its passes.  Products run at the chunks' precision (f32 on the card with
TF32 off, f64 for f64 chunks); the per-run statistics stay on the device
until a batch has ended.

On a device mesh the runs split over the ensemble axis (each rank its
share of the seeds, gathered in run order), and a model solved on a
'space' axis streams its own columns of every chunk: a counts pass sums
its partial Grams over the space group once, at its end; the projection
rows stay on their rank, where the rotation of each run reduces over the
group; a space-axis run's resampled rows are the draws that fall on the
rank's columns.
"""
import functools
from collections import namedtuple

import numpy as np
import torch

from xmca_tpu_torch.core import fastpath as _fast
from xmca_tpu_torch.core.streaming import (_packed_cols, _put_chunk,
                                           _transform_chunk, _weight_slice)
from xmca_tpu_torch.parallel import mesh as _mesh
from xmca_tpu_torch.stats.significance import (_block_indices,
                                               _resample_weights,
                                               _time_resample_runs,
                                               run_seeds)

__all__ = ['bootstrap_spectra_streamed', 'deflated_gram']

# what every part of one bootstrap round shares
_Setup = namedtuple('_Setup', [
    'loaders', 'keys',
    'p_all',       # per field: the full column count
    'p_full',      # per field: the columns this rank streams (all of them
                   # without a space mesh)
    'kept',        # per field: device index of the kept (NaN-free)
                   # columns in the full layout, None when all are kept
    'kept_loc',    # per field: device index of the kept columns among the
                   # rank's own (``kept`` without a space mesh)
    'cols',        # per field: host packed column of each of the rank's
                   # kept columns; None without a space mesh
    'mesh',        # the device mesh of a sharded model, else None
    'p',           # per field: the kept width (the jitter floor's)
    'n_obs', 'weights', 'normalize', 'dtype', 'device', 'eps',
    'H',           # the Hilbert operator of a complexified model, else None
    'complexify', 'bivariate', 'on_left', 'on_right', 'rotated',
    'kk',          # the modes of each run's subspace SVD
    'n_iter', 'power', 'tol', 'block_size', 'replace',
    'S_st', 'Wf_st',   # per field: real deflation stacks, or None
])


# ------------------------------------------------------------- helpers
def _reim_stack(X):
    """Real ``(..., 2k)`` stack ``[Re X, Im X]`` of a complex ``(..., k)``
    tensor; a real one stands for itself (its imaginary half is zero)."""
    if X.is_complex():
        X = X.resolve_conj()
        return torch.cat([X.real, X.imag], dim=-1)
    return X


def deflated_gram(G, XcW, S, W):
    """Mode-space deflation of a stored temporal Gram.

    ``G``: (n, n) real centered Gram of the transformed data; ``XcW``:
    (n, k) mode-mixed pre-Hilbert scores ``Xc W``; ``S``: (n, k)
    eigen-scaled rotated PCs; ``W``: (p, k) rotated loadings (all three
    complex for a complexified model).  Exact algebra for
    ``(Xc - real(S W^H)) (Xc - real(S W^H))^T``.  In a space context
    ``W`` is this rank's rows and ``W^T W`` sums over the shards.
    """
    XW, Ss, Ws = _reim_stack(XcW), _reim_stack(S), _reim_stack(W)
    B = XW @ Ss.T
    return G - B - B.T + (Ss @ _mesh.space_sum(Ws.T @ Ws)) @ Ss.T


def _draw(su, seed, n_total):
    """Run ``seed``'s resample indices over an axis of ``n_total`` (None:
    nothing is resampled, nothing drawn) and its subspace start block,
    from one CPU generator in the order ``bootstrap_spectra`` draws
    them; both moved to the device."""
    gen = torch.Generator().manual_seed(seed)
    idx = None
    if n_total:
        idx = _block_indices(gen, n_total, su.block_size,
                             su.replace).to(su.device)
    omega = _fast.start_block(su.n_obs, su.kk, su.dtype, gen)
    return idx, omega.to(su.device)


def _kept_rows(su, k, P):
    """The rows of a full-width per-column stack of field ``k`` (the
    rank's own columns on a space mesh) that hold its kept columns, in
    the in-memory packed order."""
    return P if su.kept_loc[k] is None else P.index_select(0, su.kept_loc[k])


def _chunks(su, k):
    """Field ``k``'s chunks as ``(c, off, lo, loff)``: the rank's columns
    of each chunk on the device, the chunk's offset in the full layout,
    the rank's first column in it and its offset in the rank's own
    layout."""
    off = loff = 0
    for chunk in su.loaders[k]():
        c, lo, wt = _put_chunk(chunk, su.dtype, su.device, su.mesh)
        if loff + c.shape[1] > su.p_full[k]:
            raise ValueError('the {} loader yields more than the model\'s '
                             '{} columns'.format(k, su.p_full[k]))
        yield c, off, lo, loff
        off += wt
        loff += c.shape[1]


def _stream_projection(su, k, Ycat):
    """One pass over field ``k``: the full-width ``(p_full, cols)``
    projection ``Xd^T Ycat`` of its transformed (and deflated) chunks,
    written chunk by chunk into one preallocated stack."""
    S_st, Wf_st = su.S_st[k], su.Wf_st[k]
    corr = None if S_st is None else S_st.T @ Ycat
    P = torch.empty((su.p_full[k], Ycat.shape[1]), dtype=su.dtype,
                    device=su.device)
    for c, off, lo, loff in _chunks(su, k):
        nt = c.shape[1]
        w = _weight_slice(su.weights.get(k), off + lo, nt, su.dtype,
                          su.device)
        cc, _, _, _ = _transform_chunk(c, w, su.normalize)
        rows = P[loff:loff + nt]
        torch.mm(cc.T, Ycat, out=rows)
        if corr is not None:
            # the deflated data's projection: Xc^T Y - W_rows (S_st^T Y)
            rows.sub_(Wf_st[loff:loff + nt] @ corr)
        del c, cc
    return P


def _rotate_runs(su, s_b, Vl, Vr):
    """Rotate each run's loadings (real stacks, combined when
    complexified): ``(variance (R, kk), converged (R,))`` as numpy."""
    var, conv = [], []
    for r, s in enumerate(s_b):
        vl = Vl[r]
        vr = Vr[r] if su.bivariate else None
        if su.complexify:
            vl = _fast.combine_analytic_projection(vl)
            vr = None if vr is None else _fast.combine_analytic_projection(vr)
        v, c, _ = _fast._rotated_variance(vl, vr, s, su.power, su.tol,
                                          'ns-gated')
        var.append(v)
        conv.append(c)
    return (torch.stack(var).to(torch.float64).cpu().numpy(),
            np.asarray(conv, dtype=bool))


def _columns(P, r, kz):
    """Run ``r``'s ``kz`` columns of a run-concatenated stack."""
    return P[:, r * kz:(r + 1) * kz]


def _project_and_rotate(su, s_b, Y_b):
    """The rotated tail of a time-axis batch: one projection pass per
    field against the runs' concatenated weights ``Y_b[field]`` (R of
    ``(n, kz)``), each run's columns, the rotation."""
    kz = Y_b['left'][0].shape[1]
    V = {}
    for k in su.keys:
        P = _kept_rows(su, k, _stream_projection(su, k,
                                                 torch.cat(Y_b[k], dim=1)))
        V[k] = [_columns(P, r, kz) for r in range(len(s_b))]
    return _rotate_runs(su, s_b, V['left'], V.get('right'))


def _counts_gram_pass(su, sources, counts):
    """One pass over the fields in ``sources`` (``(field, column offset
    in the pool's full layout)``): the counts-weighted Grams
    ``G_r = Xd diag(c_r) Xd^T`` of every run's ``counts[r]``, accumulated
    run by run as ``(cc sqrt(c_r)) (cc sqrt(c_r))^T`` into ``(R, n, n)``
    (one chunk-sized temporary, never an (R, n, chunk) stack)."""
    G = torch.zeros((counts.shape[0], su.n_obs, su.n_obs), dtype=su.dtype,
                    device=su.device)
    for k, base in sources:
        S_st, Wf_st = su.S_st[k], su.Wf_st[k]
        for c, off, lo, loff in _chunks(su, k):
            nt = c.shape[1]
            w = _weight_slice(su.weights.get(k), off + lo, nt, su.dtype,
                              su.device)
            cc, _, _, _ = _transform_chunk(c, w, su.normalize)
            if S_st is not None:
                cc.sub_(S_st @ Wf_st[loff:loff + nt].T)
            a = base + off + lo
            roots = counts[:, a:a + nt].sqrt()
            sc = torch.empty_like(cc)
            for r in range(counts.shape[0]):
                torch.mul(cc, roots[r], out=sc)
                G[r].addmm_(sc, sc.T)
            del c, cc, sc
    # the pass's one reduction over the space group
    return _mesh.all_reduce(G, su.mesh, _mesh.SPACE_AXIS)


# ---------------------------------------------------------- entry point
def bootstrap_spectra_streamed(
        loaders, keeps, grams, n_obs, n_runs, n_out_modes, *,
        weights=None, normalize=False, axis=0, on_left=True,
        on_right=False, block_size=1, replace=True, complexify=False,
        H=None, rotated=False, n_rot=0, power=1, tol=1e-8, seed=None,
        batch_size=None, subspace_iters=12, dtype=torch.float32,
        device='cpu', deflate=None, mesh=None, ensemble_axis='ensemble',
        own=None):
    """One round of bootstrap spectra of a chunk-backed model.

    The keys of :func:`xmca_tpu_torch.stats.significance.
    bootstrap_spectra`, with the data replaced by the streamed solve's
    working set: ``loaders`` (a chunk loader per field), ``keeps``
    (full-width host kept-column masks), ``grams`` (the device real
    centered Grams of the transformed data, ALREADY deflated when
    ``deflate`` is given) and ``deflate``: per field the device factors
    ``(S, W)`` of the subtracted reconstruction ``real(S W^H)`` (None for
    the standard strategy and the first iterative round).  ``H`` is the
    Hilbert operator of a complexified model; ``weights`` and
    ``normalize`` the per-chunk column scaling of every pass; ``dtype``
    the chunks' precision.

    ``axis=0`` runs in Gram space (a rotated batch adds one projection
    pass per field); ``axis=1`` makes one counts pass per batch (and a
    rotated batch a projection pass over each field).  ``batch_size``
    sets the runs a batch (default ``min(n_runs, 16)``), and so the
    passes.  ``mesh`` splits the runs over its ``ensemble_axis``; ``own``
    (per field the full-layout columns this rank streams, the solve's
    ``StreamedMCA.own``) marks a model sharded over the mesh's 'space'
    axis, whose ``deflate`` loadings are the rank's rows.

    Returns ``(spectra (n_runs, n_out_modes), converged (n_runs,))`` as
    numpy; the rows of non-converged runs are to be dropped.
    """
    if axis not in (0, 1):
        raise ValueError('{:} not a valid axis. either 0 or 1.'.format(axis))
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    keys = list(loaders)
    bivariate = len(keys) == 2
    if on_right and not bivariate:
        raise ValueError(
            'No bootstrapping possible. There is no right field. '
            'Set `on_right=False`.'
        )
    device = torch.device(device)
    keeps = {k: np.asarray(keeps[k], dtype=bool) for k in keys}
    p = {k: int(keeps[k].sum()) for k in keys}
    p.setdefault('right', p['left'])

    def _check(length):
        if length % block_size != 0:
            raise ValueError(
                'Length of data array ({:}) must be a multiple of block '
                'size {:}'.format(length, block_size)
            )

    if on_left or on_right:
        if axis == 0:
            _check(n_obs)
        elif on_left and on_right:
            _check(p['left'] + p['right'])
        else:
            _check(p['left'] if on_left else p['right'])

    kept = {k: None if keeps[k].all() else torch.as_tensor(
        np.nonzero(keeps[k])[0], device=device) for k in keys}
    if own is None:
        p_full = {k: int(keeps[k].size) for k in keys}
        kept_loc, cols, mesh_sp = kept, None, None
    else:
        p_full = {k: len(own[k]) for k in keys}
        cols, kept_loc = {}, {}
        for k in keys:
            cols[k], mine = _packed_cols(keeps[k], own[k])
            kept_loc[k] = torch.as_tensor(mine, device=device)
        mesh_sp = mesh
    S_st, Wf_st = _deflation_stacks(kept_loc, p_full, deflate or {}, dtype,
                                    device)
    su = _Setup(
        loaders=loaders, keys=keys,
        p_all={k: int(keeps[k].size) for k in keys}, p_full=p_full,
        kept=kept,
        kept_loc=kept_loc, cols=cols, mesh=mesh_sp,
        p=p, n_obs=int(n_obs), weights=weights or {}, normalize=normalize,
        dtype=dtype, device=device, eps=_fast._eps(dtype),
        H=H if complexify else None,
        complexify=complexify, bivariate=bivariate, on_left=on_left,
        on_right=on_right, rotated=rotated,
        kk=n_rot if rotated else n_out_modes, n_iter=subspace_iters,
        power=power, tol=tol, block_size=block_size, replace=replace,
        S_st=S_st, Wf_st=Wf_st)
    if batch_size is None:
        batch_size = min(n_runs, 16)
    Gl = grams['left']
    Gr = grams['right'] if bivariate else Gl
    run = (_bootstrap_axis0 if axis == 0 or not (on_left or on_right)
           else _bootstrap_axis1)
    # a request that resamples nothing runs the (no-op) Gram path

    def rows(seeds):
        # a batch's runs share its passes: each rank batches its share
        var, conv = run(su, Gl, Gr, seeds, batch_size)
        flags = np.ones(len(var)) if conv is None else conv
        return list(torch.as_tensor(np.concatenate(
            [var, np.asarray(flags, np.float64)[:, None]], axis=1)))

    with _mesh.space_context(mesh_sp):
        out = torch.stack(list(_mesh.ensemble_map(
            rows, run_seeds(seed, n_runs), mesh,
            ensemble_axis))).cpu().numpy()
    var, conv = out[:, :-1], out[:, -1] > 0.5
    spectra = var[:, :n_out_modes]
    if not rotated:
        conv = np.isfinite(spectra).all(axis=1)
    return spectra, conv


def _deflation_stacks(kept_loc, p_full, deflate, dtype, device):
    """Per field the real stacks of the deflation factors: ``S_st (n,
    2k)`` and ``W_st`` scattered to the full column layout (the rank's
    own columns on a space mesh; NaN columns zero rows); None where the
    field is not deflated."""
    S_st, Wf_st = {}, {}
    for k, kept in kept_loc.items():
        S_st[k] = Wf_st[k] = None
        if k not in deflate:
            continue
        S, W = deflate[k]
        S_st[k] = _reim_stack(S).to(dtype)
        W_st = _reim_stack(W).to(dtype)
        if kept is not None:
            full = torch.zeros((p_full[k], W_st.shape[1]), dtype=dtype,
                               device=device)
            full[kept] = W_st
            W_st = full
        Wf_st[k] = W_st
    return S_st, Wf_st


def _batches(seeds, batch_size):
    for start in range(0, len(seeds), batch_size):
        yield seeds[start:start + batch_size]


# ------------------------------------------------ axis=0: Gram resampling
def _bootstrap_axis0(su, Gl, Gr, seeds, batch_size):
    """Time-axis runs in Gram space (``significance._time_resample_runs``
    on the stored Grams); a rotated batch's weights go through one
    projection pass per field."""
    pool = [i for i, on in enumerate((su.on_left, su.on_right)) if on]
    run = _time_resample_runs([Gl, Gr][:len(su.keys)], pool,
                              [su.p[k] for k in su.keys], su.eps, su.H,
                              su.kk, su.n_iter, su.dtype)
    n_total = su.n_obs if pool else None
    if not su.rotated:
        s = [run(*_draw(su, seed, n_total), lambda s, weight: s)
             for seed in seeds]
        return torch.stack(s).to(torch.float64).cpu().numpy(), None

    def weights(s, weight):
        return s, {k: weight(i) for i, k in enumerate(su.keys)}

    var, conv = [], []
    for batch in _batches(seeds, batch_size):
        runs = [run(*_draw(su, seed, n_total), weights) for seed in batch]
        v, c = _project_and_rotate(
            su, [s for s, _ in runs],
            {k: [Y[k] for _, Y in runs] for k in su.keys})
        var.append(v)
        conv.append(c)
    return np.concatenate(var), np.concatenate(conv)


# --------------------------------------------- axis=1: counts resampling
def _bootstrap_axis1(su, Gl, Gr, seeds, batch_size):
    """Space-axis runs, per batch: the draws and their full-width column
    counts, ONE counts pass accumulating every run's Gram, the n x n
    reductions and, rotated, the projection passes and row gathers."""
    both = su.on_left and su.on_right
    if both:
        pool_w = su.p['left'] + su.p['right']
        sources = [('left', 0), ('right', su.p_all['left'])]
    else:
        side = 'left' if su.on_left else 'right'
        pool_w = su.p[side]
        sources = [(side, 0)]
    pool_full = sum(su.p_all[k] for k, _ in sources)
    # pool position -> position in the full layout the passes stream
    pool_kept = None
    if pool_w != pool_full:
        pool_kept = torch.cat([
            base + (torch.arange(su.p_all[k], device=su.device)
                    if su.kept[k] is None else su.kept[k])
            for k, base in sources])

    def counts(ii):
        c = torch.bincount(ii, minlength=pool_w).to(su.dtype)
        if pool_kept is None:
            return c
        full = torch.zeros(pool_full, dtype=su.dtype, device=su.device)
        return full.index_copy_(0, pool_kept, c)

    def chol(G, p):
        return _fast.centered_factor(G, p, su.eps, su.H)

    # the side that is not resampled keeps its original Cholesky
    La0 = chol(Gl, su.p['left']) if not su.on_left else None
    Lb0 = (chol(Gr, su.p['right'])
           if su.bivariate and not su.on_right else None)
    p_l = su.p['left']

    def factors(G, nb, r):
        if both:
            return chol(G[r], p_l), chol(G[nb + r], su.p['right'])
        if su.on_left:
            La = chol(G[r], p_l)
            return La, Lb0 if su.bivariate else La
        return La0, chol(G[r], su.p['right'])

    var, conv = [], []
    for batch in _batches(seeds, batch_size):
        draws = [_draw(su, seed, pool_w) for seed in batch]
        nb = len(draws)
        if both:
            c = [counts(i[:p_l]) for i, _ in draws] + [
                counts(i[p_l:]) for i, _ in draws]
        else:
            c = [counts(i) for i, _ in draws]
        G = _counts_gram_pass(su, sources, torch.stack(c))
        del c
        runs = []
        for r, (_, omega) in enumerate(draws):
            La, Lb, _, U, s, V = _fast._chol_reduce(
                functools.partial(factors, G, nb, r), su.n_obs - 1, omega,
                su.kk, su.n_iter, form=False)
            if su.rotated:
                runs.append((s, _resample_weights(La, U, su.H, su.dtype),
                             _resample_weights(Lb, V, su.H, su.dtype)
                             if su.bivariate else None))
            else:
                runs.append((s,))
        del G
        if not su.rotated:
            var.append(torch.stack([r[0] for r in runs]).to(
                torch.float64).cpu().numpy())
            continue
        v, cv = _axis1_project_rotate(su, runs, draws, sources, both)
        var.append(v)
        conv.append(cv)
    return np.concatenate(var), (np.concatenate(conv) if conv else None)


def _pool_rows(su, sources):
    """Draws over the pool's packed columns -> the rows of the rank's
    pool projection that hold them: the draws themselves without a space
    mesh; on one, the draws that fall on the rank's own columns (a run's
    rotation sums over the rows of every rank)."""
    if su.cols is None:
        return lambda i: i
    base = {'left': 0, 'right': su.p['left'] if len(sources) == 2 else 0}
    pos = np.concatenate([base[k] + su.cols[k] for k, _ in sources])
    return _mesh.draws_on_rank(torch.as_tensor(pos, device=su.device),
                               sum(su.p[k] for k, _ in sources))


def _axis1_project_rotate(su, runs, draws, sources, both):
    """The rotated tail of a space-axis batch: one projection pass over
    the pool's field(s) against the weights of the resampled side(s),
    each run's rows gathered from it; a bivariate one-sided draw adds one
    pass over the other field, whose loadings are not resampled."""
    nb = len(runs)
    kz = runs[0][1].shape[1]
    s_b = [r[0] for r in runs]

    def cat(i):
        return torch.cat([r[i] for r in runs], dim=1)

    if both:
        Ycat = torch.cat([cat(1), cat(2)], dim=1)
    else:
        Ycat = cat(2) if su.on_right else cat(1)
    parts = [_kept_rows(su, k, _stream_projection(su, k, Ycat))
             for k, _ in sources]
    P = parts[0] if len(parts) == 1 else torch.cat(parts)
    del parts
    p_l = su.p['left']
    rows = _pool_rows(su, sources)
    if both:
        Vl = [P[rows(i[:p_l]), r * kz:(r + 1) * kz]
              for r, (i, _) in enumerate(draws)]
        Vr = [P[rows(i[p_l:]), (nb + r) * kz:(nb + r + 1) * kz]
              for r, (i, _) in enumerate(draws)]
        del P
        return _rotate_runs(su, s_b, Vl, Vr)
    Vs = [P[rows(i), r * kz:(r + 1) * kz] for r, (i, _) in enumerate(draws)]
    del P
    other = None
    if su.bivariate:
        k = 'right' if su.on_left else 'left'
        Po = _kept_rows(su, k, _stream_projection(
            su, k, cat(2) if su.on_left else cat(1)))
        other = [_columns(Po, r, kz) for r in range(nb)]
    if su.on_left:
        return _rotate_runs(su, s_b, Vs, other)
    return _rotate_runs(su, s_b, other, Vs)

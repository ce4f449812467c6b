"""Out-of-core (streamed) MCA of fields larger than the card's memory.

Counterpart of ``xmca_tpu/core/streaming.py``.  The solve contracts only
over the space axis, so the data streams through the card in column
chunks, each a host ``(n_obs, p_chunk)`` array from a loader:

* pass 1: each chunk is centered on the card (chunks split the columns,
  so every column's full series is chunk-local and the centering is
  exact; never the raw Gram with a rank-1 correction) and its temporal
  Gram accumulated in the chunk's precision (f32 on the card, TF32 off);
* reduce: the n x n analytic fold (complexified), the jitter, Cholesky,
  the reduced kernel, the subspace SVD and the exact totals;
* pass 2: the spatial vectors stream back out per chunk, ``V = Xc^T Z``,
  with the PC series accumulated on the way.

With ``extend`` ('exp'/'theta') the fold cannot express the boundary
forecast, so both passes complexify each chunk on the card and
accumulate its complex Gram ``Z Z^H`` directly.

Peak device memory is one chunk and its temporaries plus the n x n state
and the ``(p, k)`` spatial vectors, which stay on the card as the model's
basis.  Columns with a NaN are zeroed, not dropped (a zero column adds
nothing to any contraction).  The per-chunk statistics stay on the card
until a pass has ended and come to the host in one copy.  Every chunk is
copied before the passes work on it in place, so a loader's arrays (a
read-only memmap, say) are never written.

Chunk precision: float64 chunks solve in float64, every other dtype in
float32 (:func:`stream_dtype`).

On a device mesh with a 'space' axis (``mesh``), every rank uploads its
share of each chunk's columns (:func:`_chunk_share`: the true columns of
its block of the chunk padded to a multiple of the shard count, as the
JAX package lays a chunk out; the pad columns are never made, so none
reaches a column statistic).  A pass sums its partial Grams, score
accumulators and column statistics over the space group ONCE, at its end;
the spatial vectors stay sharded (``StreamedMCA.cols``: the global packed
column of each local row).
"""
from collections import namedtuple

import numpy as np
import torch

from xmca_tpu_torch.core import fastpath as _fast
from xmca_tpu_torch.core import preprocess as _pre
from xmca_tpu_torch.parallel import mesh as _mesh

__all__ = ['StreamedMCA', 'chunks_from_array', 'stream_dtype',
           'streamed_gram', 'streamed_mca', 'streamed_fields',
           'streamed_patterns']

StreamedMCA = namedtuple('StreamedMCA', [
    'svals',                 # (k,) host
    'V_left', 'V_right',     # (p_kept, k) device loadings (complex if analytic)
    'total_covariance',      # exact nuclear norm of the reduced kernel
    'total_squared_covariance',   # exact Frobenius norm squared
    'scores_left', 'scores_right',  # (n, k) device unwhitened PC series
    'means', 'stds',         # {'left'/'right': (p_kept,)} host column stats
    'keep',                  # {'left'/'right': (p,) bool} non-NaN columns
    'grams',        # {'left'/'right': (n, n)} device centered Grams of the
                    # transformed data, before the jitter and the fold;
                    # extended solves store the complex Z Z^H
    'scores_pre',   # {'left'/'right': (n, k)} device pre-Hilbert raw
                    # scores ``Xc V`` (equal to the scores for real solves)
    'own',          # {'left'/'right': (p_local,)} host full-layout column
                    # of each column this rank streams; None unsharded
    'cols',         # {'left'/'right': (p_kept_local,)} host packed column
                    # of each row of this rank's V; None unsharded
])


def chunks_from_array(X, chunk_size):
    """Iterate an in-memory ``(n, p)`` array in ``(n, <= chunk)`` slabs."""
    for s in range(0, X.shape[1], chunk_size):
        yield X[:, s:s + chunk_size]


def stream_dtype(chunk):
    """The precision a streamed field is solved in: float64 for float64
    chunks, float32 for any other."""
    return (torch.float64 if np.asarray(chunk).dtype == np.float64
            else torch.float32)


_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _chunk_share(wt, mesh):
    """``(lo, hi)``: the columns of a ``wt``-column chunk this rank
    streams: on a space mesh of S shards, the true columns of its block
    of ``ceil(wt / S)`` (the last blocks short or empty); all of them
    without one."""
    shards = _mesh.axis_size(mesh, _mesh.SPACE_AXIS)
    if shards == 1:
        return 0, wt
    per = -(-wt // shards)
    lo = min(_mesh.axis_rank(mesh, _mesh.SPACE_AXIS) * per, wt)
    return lo, min(lo + per, wt)


def _put_chunk(chunk, dtype, device, mesh=None):
    """This rank's columns of one host chunk as a tensor of the caller's
    own, on ``device`` in ``dtype``: ``(chunk, lo, wt)``, ``lo`` the
    offset of its first column in the chunk and ``wt`` the chunk's whole
    width.  On the CPU, and for a read-only array, the host data is
    copied first, so the in-place transform never writes into the
    loader's array."""
    a = np.asarray(chunk)
    wt = a.shape[1]
    lo, hi = _chunk_share(wt, mesh)
    if (lo, hi) != (0, wt):
        a = a[:, lo:hi]
    if device.type == 'cpu' or not a.flags.writeable:
        a = np.array(a, dtype=_NUMPY_DTYPE[dtype])
    return torch.from_numpy(a).to(device=device, dtype=dtype), lo, wt


def _packed_cols(keep, own):
    """The packed (NaN-free) column of each kept column this rank
    streams, and the kept ones' positions in its own layout."""
    mine = np.nonzero(keep[own])[0]
    return (np.cumsum(keep) - 1)[own[mine]], mine


def _zero_nan_cols(c):
    """Zero, in place, every column of ``c`` that holds a NaN: the same as
    dropping it from every contraction.  Returns ``(c, nan_cols)``."""
    nan_cols = torch.isnan(c).any(dim=0)
    return c.masked_fill_(nan_cols[None, :], 0), nan_cols


def _transform_chunk(c, w, normalize):
    """The per-chunk preprocessing of every streamed pass, in place on
    the private chunk ``c``: NaN columns zeroed, exact centering, then the
    column weights ``w`` (None: none) and, with ``normalize``, the division
    by the chunk's raw std (a NaN column keeps a unit divisor and stays
    zero; a zero-variance column divides to NaN, as in memory).

    Returns ``(cc, mu, var, nan_cols)`` with the RAW column statistics.
    """
    c, nan_cols = _zero_nan_cols(c)
    mu = c.mean(dim=0)
    cc = c.sub_(mu)
    var = torch.mean(cc * cc, dim=0)
    if w is not None:
        cc.mul_(w)
    if normalize:
        cc.div_(torch.where(nan_cols, 1.0, torch.sqrt(var)))
    return cc, mu, var, nan_cols


def _accumulate(G, c, w, normalize):
    """Pass-1 update: transform the chunk and add its Gram to ``G`` in
    place; returns the chunk's raw statistics (kept on the device)."""
    cc, mu, var, nan_cols = _transform_chunk(c, w, normalize)
    G.addmm_(cc, cc.T)
    return mu, var, nan_cols


def _accumulate_ext(G, c, w, normalize, extend, period):
    """Pass-1 update of a boundary-extended complexified solve: the chunk
    is extended and complexified on the device (each column carries its
    full series, so the extension is chunk-local) and its Hermitian Gram
    ``Z Z^H`` added to the complex ``G``."""
    cc, mu, var, nan_cols = _transform_chunk(c, w, normalize)
    z = _pre.complexify(cc, extend=extend, period=period)
    G.addmm_(z, z.mH)
    return mu, var, nan_cols


def _weight_slice(weights, off, wt, dtype, device):
    """A chunk's slice of a column-weight spec: None (no weights), a
    scalar or a full-width ``(p,)`` host vector."""
    if weights is None:
        return None
    if np.ndim(weights) == 0:
        return torch.full((wt,), float(weights), dtype=dtype, device=device)
    return torch.as_tensor(np.ascontiguousarray(weights[off:off + wt]),
                           device=device).to(dtype)


def streamed_gram(chunks, n_obs, dtype=None, device='cpu', weights=None,
                  normalize=False, extend=False, period=1, mesh=None):
    """Centered temporal Gram of a streamed field (pass 1).

    ``chunks``: an iterable of host ``(n_obs, p_chunk)`` arrays; ``dtype``
    the precision (None: :func:`stream_dtype` of the first chunk).  With
    ``extend`` each chunk is extended and complexified and the Gram is the
    complex ``Z Z^H``.  Returns ``(G, p_kept, mean, std, keep)``: the
    ``(n_obs, n_obs)`` Gram on the device, the count of NaN-free columns
    (the contracted width the jitter floor scales with), their RAW host
    means and stds, and the full-width host keep mask; on a space
    ``mesh`` summed over the shards.
    """
    return _gram_pass(chunks, n_obs, dtype, device, weights, normalize,
                      extend, period, mesh)[:5]


def _gram_pass(chunks, n_obs, dtype, device, weights, normalize, extend,
               period, mesh):
    """:func:`streamed_gram` and the full-layout column of each column
    this rank streams (None without a space mesh)."""
    device = torch.device(device)
    G = None
    starts, means, vars_, masks = [], [], [], []
    off = 0
    for chunk in chunks:
        if dtype is None:
            dtype = stream_dtype(chunk)
        if G is None:
            G = torch.zeros((n_obs, n_obs), device=device,
                            dtype=_fast._complex_dtype(dtype) if extend
                            else dtype)
        c, lo, wt = _put_chunk(chunk, dtype, device, mesh)
        starts.append((off + lo, c.shape[1]))
        w = _weight_slice(weights, off + lo, c.shape[1], dtype, device)
        off += wt
        if extend:
            mu, var, nan_cols = _accumulate_ext(G, c, w, normalize, extend,
                                                period)
        else:
            mu, var, nan_cols = _accumulate(G, c, w, normalize)
        del c
        means.append(mu)
        vars_.append(var)
        masks.append(nan_cols.to(dtype))
    if G is None:
        z = np.zeros(0)
        return G, 0, z, z, np.zeros(0, bool), None
    stats = torch.cat(means + vars_ + masks)
    own = None
    if _mesh.axis_size(mesh, _mesh.SPACE_AXIS) > 1:
        # the pass's one reduction: the Gram and every statistic, each
        # rank's at its columns' full-layout positions
        own = np.concatenate([np.arange(a, a + n) for a, n in starts])
        full = torch.zeros((3, off), dtype=stats.dtype, device=device)
        full[:, torch.as_tensor(own, device=device)] = stats.reshape(3, -1)
        G, stats = _mesh.all_reduce_many([G, full.reshape(-1)], mesh,
                                         _mesh.SPACE_AXIS)
    # one copy to the host for every per-chunk statistic, after the pass
    flat = stats.cpu().numpy()
    mean, var, nan_cols = flat[:off], flat[off:2 * off], flat[2 * off:] > 0.5
    keep = ~nan_cols
    mean, var = mean[keep], var[keep]
    return (G, int(keep.sum()), mean, np.sqrt(np.maximum(var, 0.0)), keep,
            own)


def _real_times(x, P):
    """``x @ P`` for real ``x`` and real or complex ``P`` as real
    products (no complex copy of ``x``)."""
    if P.is_complex():
        return torch.complex(x @ P.real, x @ P.imag)
    return x @ P


def _project_chunk(c, Z, A, w, complexify, normalize):
    """Pass-2 update: the chunk's spatial vectors ``P = Xc^T Z`` (``Z`` the
    real recovery matrix, the ``[Re, Im]`` stack for analytic solves) and
    the score accumulator ``A += Xc P`` (in place, on the stack)."""
    cc, _, _, _ = _transform_chunk(c, w, normalize)
    P = cc.T @ Z
    A.addmm_(cc, P)
    return _fast.combine_analytic_projection(P) if complexify else P


def _project_chunk_ext(c, Zw, A, Ap, w, normalize, extend, period):
    """Pass-2 update of a boundary-extended solve: the complex chunk is
    rebuilt as in pass 1 and projected on the complex recovery matrix
    ``Zw``: ``P = Z^H Zw``, ``A += Z P`` and the pre-Hilbert ``Ap += Xc P``
    (in place)."""
    cc, _, _, _ = _transform_chunk(c, w, normalize)
    z = _pre.complexify(cc, extend=extend, period=period)
    P = z.mH @ Zw
    A.addmm_(z, P)
    Ap.add_(_real_times(cc, P))
    return P


def _fields_chunk(c, w, H, inv_w, complexify, normalize, original, extend,
                  period):
    """One chunk of the ``fields()`` view: the preprocessed (and
    complexified) data, with ``original`` the inverse scaling (``inv_w``,
    the xMCA coslat inverse, then the std and the mean); NaN columns come
    back as NaN."""
    cc, mu, var, nan_cols = _transform_chunk(c, w, normalize)
    if complexify and extend:
        z = _pre.complexify(cc, extend=extend, period=period)
    elif complexify:
        z = torch.complex(cc, H @ cc)
    else:
        z = cc
    if original:
        if inv_w is not None:
            z = z * inv_w
        if normalize:
            z = z * torch.sqrt(var)
        z = z + mu
    return z.masked_fill_(nan_cols[None, :], float('nan'))


def streamed_fields(loader, n_obs, *, complexify=False, extend=False,
                    period=1, weights=None, normalize=False,
                    original_scale=False, inv_colmul=None, dtype=None,
                    device='cpu', mesh=None):
    """A streamed field as one host ``(n_obs, p)`` array, the loader read
    once with the model's per-chunk transform (the chunk-backed
    ``fields()``); ``inv_colmul`` is a full-width per-column inverse that
    ``original_scale`` applies before un-normalizing.  Each chunk's result
    is copied to the host as it is made: the full field never sits on the
    card.  On a space ``mesh`` each chunk is gathered from the shards
    (one sum a chunk)."""
    device = torch.device(device)
    extend = extend if complexify else False
    H = None
    parts, off = [], 0
    for chunk in loader():
        if dtype is None:
            dtype = stream_dtype(chunk)
        if complexify and not extend and H is None:
            H = _fast.hilbert_operator(n_obs, dtype, device)
        c, lo, wt = _put_chunk(chunk, dtype, device, mesh)
        nt = c.shape[1]
        w = _weight_slice(weights, off + lo, nt, dtype, device)
        inv_w = _weight_slice(inv_colmul, off + lo, nt, dtype, device)
        off += wt
        z = _fields_chunk(c, w, H, inv_w, complexify, normalize,
                          original_scale, extend, period)
        if nt != wt:
            full = z.new_zeros((n_obs, wt))
            full[:, lo:lo + nt] = z
            z = _mesh.all_reduce(full, mesh, _mesh.SPACE_AXIS)
        parts.append(z.cpu().resolve_conj().numpy())
    return np.concatenate(parts, axis=1)


def _pattern_chunk(c, w, Sc, s_norm, normalize):
    """One chunk of a correlation map: Pearson r of the chunk's
    transformed columns against the centered PC series ``Sc``."""
    cc, _, _, _ = _transform_chunk(c, w, normalize)
    num = cc.T @ Sc
    return num / (torch.linalg.norm(cc, dim=0)[:, None] * s_norm[None, :])


def streamed_patterns(loader, n_obs, Sc, s_norm, *, weights=None,
                      normalize=False, dtype=None, device='cpu', mesh=None):
    """Correlation map ``(p, k)`` (host) of a streamed field against the
    centered real PC series ``Sc (n_obs, k)`` on the device, with norms
    ``s_norm``; one pass over the loader (on a space ``mesh``, the
    shards' rows gathered at its end).  NaN (zeroed) columns come out as
    0/0 = NaN rows."""
    device = torch.device(device)
    parts, own, off = [], [], 0
    for chunk in loader():
        if dtype is None:
            dtype = stream_dtype(chunk)
        c, lo, wt = _put_chunk(chunk, dtype, device, mesh)
        w = _weight_slice(weights, off + lo, c.shape[1], dtype, device)
        own.append(np.arange(off + lo, off + lo + c.shape[1]))
        off += wt
        parts.append(_pattern_chunk(c, w, Sc.to(dtype), s_norm.to(dtype),
                                    normalize))
    r = torch.cat(parts)
    if _mesh.axis_size(mesh, _mesh.SPACE_AXIS) > 1:
        r = _mesh.gather_rows(r, np.concatenate(own), off, mesh)
    return r.cpu().numpy()


def _fold_score_hilbert(A, H):
    """Analytic PC series from the real-data accumulator:
    ``Xz V = (I + iH) Xc V = A + i H A``."""
    HA = torch.complex(H @ A.real, H @ A.imag)
    return A + 1j * HA


def streamed_mca(chunks_left, chunks_right, n_obs, n_modes, *,
                 complexify=False, extend=False, period=1, seed=0,
                 n_iter=12, jitter_rel=1e-6, device='cpu', weights=None,
                 normalize=False, mesh=None):
    """Truncated (complex) MCA of two streamed fields.

    ``chunks_left``, ``chunks_right``: callables returning a fresh
    iterable of host ``(n_obs, p_chunk)`` arrays (each field is read
    twice: the Gram pass and the projection pass); ``chunks_right`` None
    for a PCA.  ``complexify``: the analytic-signal MCA by the Gram fold
    (Z never exists), or with ``extend`` ('exp'/'theta', ``period``) on
    the complexified chunks.  ``seed`` seeds the subspace start block, as
    the in-memory truncated solve draws it (a ``torch.Generator`` on
    ``device``).  ``weights`` (``{'left'/'right': scalar or (p,) vector}``)
    and ``normalize`` scale the columns in every pass.  ``mesh``: a
    device mesh whose 'space' axis shards every chunk's columns (the
    loadings come back as this rank's rows).

    Returns a :class:`StreamedMCA`: the loadings, PC series, Grams and
    pre-Hilbert scores on the device; the spectrum, the totals and the
    column statistics on the host.
    """
    device = torch.device(device)
    bivariate = chunks_right is not None
    weights = weights or {}
    extend = extend if complexify else False
    H, dtype = None, None
    means, stds, keeps, grams, own = {}, {}, {}, {}, {}

    def field_gram(loader, side):
        # the left field's first chunk sets the precision of both
        nonlocal H, dtype
        G, p, means[side], stds[side], keeps[side], own[side] = _gram_pass(
            loader(), n_obs, dtype, device, weights.get(side), normalize,
            extend, period, mesh)
        if p == 0:
            raise RuntimeError(
                'the %s field has no NaN-free columns — nothing to '
                'decompose.' % side)
        grams[side] = G
        dtype = G.real.dtype
        if complexify and not extend and H is None:
            # one Hilbert operator for both fields
            H = _fast.hilbert_operator(n_obs, dtype, device)
        # the analytic fold (H) only where the chunks were not complexified
        return _fast._fold_jitter(G, p, _fast._eps(dtype), H, jitter_rel)

    Gl = field_gram(chunks_left, 'left')
    Gr = field_gram(chunks_right, 'right') if bivariate else Gl

    def factors():
        La = _fast._cholesky(Gl)
        return La, _fast._cholesky(Gr) if bivariate else La

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    omega = _fast.start_block(n_obs, n_modes, Gl.dtype, gen)
    La, Lb, M, U, s, V = _fast._chol_reduce(factors, n_obs - 1, omega,
                                            n_modes, n_iter, form=True)
    totals = torch.stack([_fast.nuclear_norm(M), torch.sum(torch.abs(M) ** 2)])
    del Gl, Gr, M

    def recover(loader, L_chol, T_side, keep, side):
        # the real recovery matrix, the analytic [Re, Im] stack where
        # folded; an extended solve's complex one
        Z = _fast._recover(L_chol, T_side, H)
        A = torch.zeros((n_obs, Z.shape[1]), dtype=Z.dtype, device=device)
        A_pre = torch.zeros_like(A) if extend else None
        parts, off = [], 0
        for chunk in loader():
            c, lo, wt = _put_chunk(chunk, dtype, device, mesh)
            w = _weight_slice(weights.get(side), off + lo, c.shape[1], dtype,
                              device)
            off += wt
            if extend:
                P = _project_chunk_ext(c, Z, A, A_pre, w, normalize, extend,
                                       period)
            else:
                P = _project_chunk(c, Z, A, w, complexify, normalize)
            del c
            parts.append(P)
        # the pass's one reduction: the score accumulators
        if extend:
            A, A_pre = _mesh.all_reduce_many([A, A_pre], mesh,
                                             _mesh.SPACE_AXIS)
        else:
            A = _mesh.all_reduce(A, mesh, _mesh.SPACE_AXIS)
        # the pre-Hilbert accumulator holds the real data's raw scores
        # ``Xc V``; analytic solves fold the Hilbert operator in after
        if not extend:
            if complexify:
                A = _fast.combine_analytic_projection(A)
            A_pre = A
            if complexify:
                A = _fold_score_hilbert(A, H)
        Vf = torch.cat(parts)
        del parts
        # NaN columns came through as zero rows: pack them out, as the
        # in-memory ingestion drops them
        cols = None
        if own[side] is not None:
            cols, mine = _packed_cols(keep, own[side])
            Vf = Vf[torch.as_tensor(mine, device=device)]
        elif not keep.all():
            Vf = Vf[torch.as_tensor(keep, device=device)]
        return Vf, A, A_pre, cols

    V_left, S_left, P_left, c_left = recover(chunks_left, La, U,
                                             keeps['left'], 'left')
    if bivariate:
        V_right, S_right, P_right, c_right = recover(
            chunks_right, Lb, V, keeps['right'], 'right')
    else:
        V_right, S_right, P_right, c_right = V_left, S_left, P_left, c_left
    totals = totals.cpu().numpy()
    sharded = own['left'] is not None
    return StreamedMCA(
        s.cpu().numpy(), V_left, V_right, float(totals[0]),
        float(totals[1]), S_left, S_right, means, stds, keeps, grams,
        {'left': P_left, 'right': P_right},
        own if sharded else None,
        {'left': c_left, 'right': c_right} if sharded else None)

"""Surrogate fields for Rule-N ensembles, drawn on the device.

Every draw comes from Philox4x32-10 (Salmon et al. 2011, "Parallel
random numbers: as easy as 1, 2, 3"; device copy ``csrc/philox.cuh``);
the second key word is a stream id that names the draw family, so two
families never share bits.  Two families:

**+-1 fields** (kernel ``csrc/sign_field.cu``, stream ``SIGN_STREAM``).
:func:`sign_field_sums` draws one masked +-1 int8 field in the padded
layout :func:`xmca_tpu_torch.ops.syrk.syrk` reads, plus its int32 column
sums, in one pass:

* key ``(seed ^ 0x53474E53, SIGN_STREAM)``;
* counter ``(row, column group, 0, 0)`` per 128-column group;
* output word ``w``, bit ``b`` -> column ``128 * group + 32 * w + b``;
  bit 1 is +1, bit 0 is -1; rows ``>= n`` and columns ``>= p`` are 0.

**Generated fields** (stream ``GEN_STREAM``; kernels
``csrc/surrogate_field.cu``, ``surrogate_gram.cu`` and
``surrogate_project.cu``, layout and map in ``csrc/gen_draw.cuh``), the
counterpart of the JAX package's unsalted tile family
(``xmca_tpu/ops/surrogate.py``): :func:`surrogate_field` writes the
field, :func:`surrogate_gram` its raw Gram and column means and
:func:`surrogate_project` the product ``X^T S``, the last two without
storing the field.

* key ``(seed mod 2^32, GEN_STREAM)``;
* element ``(row, col)`` is output word ``col % 4`` of the call at
  counter ``(row, col // 4, 0, 0)``: one full 32-bit word per element,
  depending only on ``(seed, row, col)``, never on a block or tile
  size, so every kernel regenerates exactly what another drew;
* the word ``w`` maps to a value as :func:`bits_to_draw` says
  (``normal32``, ``normal16``, ``rademacher`` in bf16; ``rademacher8``
  in int8); inside the kernels rows ``>= n`` and columns ``>= p`` are 0.

Each kernel has a plain PyTorch version here (int64 arithmetic on
32-bit lanes) that gives the same bits on the same seed; a wrapper takes
it for a CPU device and launches the kernel (counting the launch) or
raises for a CUDA one.
"""
import ctypes

import torch

from xmca_tpu_torch.ops import _build
from xmca_tpu_torch.ops.syrk import (COL_PAD, ROW_PAD, TILE, _sm_count,
                                     data_ptr, order_table, schedule,
                                     wave_counter, workspace_tiles)
from xmca_tpu_torch.utils import trace

__all__ = ['sign_field_sums', 'sign_field_sums_reference', 'philox4x32_10',
           'SIGN_SALT', 'SIGN_STREAM', 'GEN_STREAM', 'GEN_DISTS',
           'words_reference', 'bits_to_draw', 'surrogate_field',
           'surrogate_field_reference', 'surrogate_gram',
           'surrogate_gram_reference', 'gram_from_field', 'gram_from_chunks',
           'chunk_plan', 'CHUNK_COLS', 'centered_gram_from_raw',
           'surrogate_project',
           'surrogate_project_reference', 'project_from_field']

SIGN_SALT = 0x53474E53           # 'SGNS', the TPU kernel's salt
SIGN_STREAM = 0
GEN_STREAM = 1
# order = the kernels' dist ids (csrc/gen_draw.cuh)
GEN_DISTS = ('normal32', 'normal16', 'rademacher', 'rademacher8')
GROUP = 128                      # columns per Philox output
# surrogate_gram's column chunk: a multiple of COL_PAD; the fastest of
# 4096, 8192 and 16384 on the card (PERF.md)
CHUNK_COLS = 16384
# +-1 distributions, whose Gram runs on K1's int8 path
_PM1_DISTS = ('rademacher', 'rademacher8')
_INV_SQRT8 = 0.3535533905932738
_MASK32 = 0xFFFFFFFF
# int64 bit lanes (rows x groups x 32) sign_field_sums_reference draws
# at once
_REF_LANES = 1 << 27
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m, c):
    """(hi, lo) 32-bit halves of ``m * c`` for a 32-bit constant ``m``
    and an int64 tensor ``c`` of 32-bit lanes, without int64 overflow:
    ``c`` is split into 16-bit halves so every partial product stays
    below 2^48."""
    t1 = m * (c & 0xFFFF)
    t2 = m * (c >> 16)
    hi = (t2 + (t1 >> 16)) >> 16
    lo = (((t2 & 0xFFFF) << 16) + t1) & _MASK32
    return hi & _MASK32, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit counter lanes and
    Python-int key words; returns the four 32-bit output lanes (int64)."""
    k0 &= _MASK32
    k1 &= _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def _check_shape(n, p, n_pad, p_pad):
    if n_pad % ROW_PAD or p_pad % COL_PAD or not (
            0 < n <= n_pad and 0 < p <= p_pad):
        raise ValueError(
            'sign_field_sums expects 0 < n <= n_pad, 0 < p <= p_pad, '
            'n_pad % {} == 0 and p_pad % {} == 0; got n={}, p={}, '
            'n_pad={}, p_pad={}'.format(ROW_PAD, COL_PAD, n, p, n_pad,
                                        p_pad))


def sign_field_sums_reference(seed, n, p, n_pad, p_pad, device='cpu'):
    """Plain PyTorch twin of the kernel: ``(X int8 (n_pad, p_pad),
    colsum int32 (p_pad,))`` with identical bits.  Rows are drawn in
    blocks whose int64 bit lanes stay under ``_REF_LANES``, so a field
    of 10^10 cells takes little more memory than itself."""
    _check_shape(n, p, n_pad, p_pad)
    groups = p_pad // GROUP
    step = max(1, _REF_LANES // (32 * groups))
    grp = torch.arange(groups, dtype=torch.int64, device=device)
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    X = torch.empty((n_pad, p_pad), dtype=torch.int8, device=device)
    colsum = torch.zeros((p_pad,), dtype=torch.int32, device=device)
    for r0 in range(0, n_pad, step):
        rows = torch.arange(r0, min(r0 + step, n_pad), dtype=torch.int64,
                            device=device)
        c0 = rows[:, None].expand(len(rows), groups)
        c1 = grp[None, :].expand(len(rows), groups)
        zero = torch.zeros_like(c0)
        words = philox4x32_10(c0, c1, zero, zero,
                              (int(seed) & _MASK32) ^ SIGN_SALT, SIGN_STREAM)
        bits = torch.stack(
            [((w[:, :, None] >> shifts) & 1).to(torch.int8) for w in words],
            dim=2,
        )                                      # (rows, groups, 4, 32)
        Xb = X[r0:r0 + len(rows)]
        Xb.copy_((bits * 2 - 1).reshape(len(rows), p_pad))
        Xb[max(n - r0, 0):] = 0
        Xb[:, p:] = 0
        colsum += Xb.sum(dim=0, dtype=torch.int32)
    return X, colsum


def sign_field_sums(seed, n, p, n_pad, p_pad, device):
    """Masked +-1 int8 field and its int32 column sums, one pass.

    ``seed`` is taken modulo 2^32.  On a CPU device this is
    :func:`sign_field_sums_reference`; on a CUDA device it launches the
    kernel (and counts the launch) or raises.
    """
    device = torch.device(device)
    if device.type == 'cpu':
        return sign_field_sums_reference(seed, n, p, n_pad, p_pad, device)
    if device.type != 'cuda':
        raise ValueError('sign_field_sums runs on cuda or cpu, not {}'
                         .format(device))
    _check_shape(n, p, n_pad, p_pad)
    lib = _build.library()
    X = torch.empty((n_pad, p_pad), dtype=torch.int8, device=device)
    colsum = torch.empty((p_pad,), dtype=torch.int32, device=device)
    err = lib.xmca_sign_field_sums(
        X.data_ptr(), colsum.data_ptr(), n, p, n_pad, p_pad,
        int(seed) & _MASK32, SIGN_STREAM, _build.stream_of(X))
    _build.check(err, 'sign_field_sums')
    trace.count('launches', 'sign_field_sums')
    return X, colsum


# ------------------------------------------------------ generated fields
def _popcount32(w):
    """Set bits of each 32-bit lane of an int64 tensor (SWAR)."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) & _MASK32) >> 24


def _check_gen(n, p, dist):
    if dist not in GEN_DISTS:
        raise ValueError('unknown surrogate distribution: {!r} (one of {})'
                         .format(dist, GEN_DISTS))
    if not (0 < n < 2 ** 31 and 0 < p < 2 ** 31):
        raise ValueError('surrogate fields need 0 < n, p < 2^31; got n={}, '
                         'p={}'.format(n, p))


def words_reference(seed, n, p, device='cpu'):
    """The generated family's random words of an (n, p) field, as int64
    holding 32-bit values: element (r, c) is word ``c % 4`` of Philox at
    counter ``(r, c // 4, 0, 0)`` under key ``(seed, GEN_STREAM)``."""
    groups = -(-p // 4)
    rows = torch.arange(n, dtype=torch.int64, device=device)
    grp = torch.arange(groups, dtype=torch.int64, device=device)
    c0 = rows[:, None].expand(n, groups)
    c1 = grp[None, :].expand(n, groups)
    zero = torch.zeros((n, groups), dtype=torch.int64, device=device)
    words = philox4x32_10(c0, c1, zero, zero, int(seed) & _MASK32,
                          GEN_STREAM)
    return torch.stack(words, dim=2).reshape(n, 4 * groups)[:, :p]


def bits_to_draw(words, dist):
    """Random 32-bit words -> surrogate values, the map of the JAX
    package's ``_bits_to_draw``: bf16 for ``normal32`` (standardized
    Binomial(32, 1/2), computed in f32 and rounded to nearest even),
    ``normal16`` (Binomial(16, 1/2) of the low half-word) and
    ``rademacher`` (bit 0: 1 -> +1, 0 -> -1); int8 for ``rademacher8``.
    'rademacher1' is no word map here, as in the JAX package: Rule-N
    draws it with the +-1 draw kernel, one random bit an element."""
    w = words.to(torch.int64) & _MASK32
    if dist == 'rademacher':
        return torch.where((w & 1) == 1, 1.0, -1.0).to(torch.bfloat16)
    if dist == 'rademacher8':
        return torch.where((w & 1) == 1, 1, -1).to(torch.int8)
    if dist == 'normal32':
        pc = _popcount32(w).to(torch.float32)
        scale = torch.tensor(_INV_SQRT8, dtype=torch.float32,
                             device=w.device)
        return ((pc - 16.0) * scale).to(torch.bfloat16)
    if dist == 'normal16':
        pc = _popcount32(w & 0xFFFF).to(torch.float32)
        return ((pc - 8.0) * 0.5).to(torch.bfloat16)
    raise ValueError('unknown surrogate distribution: {!r}'.format(dist))


def surrogate_field_reference(seed, n, p, dist, device='cpu'):
    """Plain PyTorch twin of the field kernel: the (n, p) field, bf16
    (int8 for ``rademacher8``), bit for bit."""
    _check_gen(n, p, dist)
    return bits_to_draw(words_reference(seed, n, p, device), dist)


def _gen_device(device, name):
    device = torch.device(device)
    if device.type not in ('cpu', 'cuda'):
        raise ValueError('{} runs on cuda or cpu, not {}'.format(
            name, device))
    return device


def surrogate_field(seed, n, p, dist, device):
    """The generated (n, p) field of ``seed`` (taken modulo 2^32): bf16,
    or int8 for ``rademacher8``.  Rule-N's 'normal16', 'normal32' and
    'rademacher' runs solve these fields
    (``stats.significance.rule_n_generated``), and it is the oracle of
    :func:`surrogate_gram` and :func:`surrogate_project`, which
    regenerate the same values."""
    device = _gen_device(device, 'surrogate_field')
    _check_gen(n, p, dist)
    if device.type == 'cpu':
        return surrogate_field_reference(seed, n, p, dist, device)
    lib = _build.library()
    dtype = torch.int8 if dist == 'rademacher8' else torch.bfloat16
    X = torch.empty((n, p), dtype=dtype, device=device)
    err = lib.xmca_surrogate_field(X.data_ptr(), n, p, int(seed) & _MASK32,
                                   GEN_DISTS.index(dist),
                                   _build.stream_of(X))
    _build.check(err, 'surrogate_field')
    trace.count('launches', 'surrogate_field')
    return X


def gram_from_field(X):
    """``(G, mu, u, mumu)`` of a materialized (n, p) field: the raw Gram
    ``X X^T``, the column means, ``u = X mu`` and ``mu . mu``, each
    accumulated in f64 (every product of two draws is exact) and
    returned as f32."""
    Xd = X.to(torch.float64)
    mu = Xd.mean(dim=0)
    return ((Xd @ Xd.T).to(torch.float32), mu.to(torch.float32),
            (Xd @ mu).to(torch.float32), (mu @ mu).to(torch.float32))


def surrogate_gram_reference(seed, n, p, dist, device='cpu'):
    """Plain version of :func:`surrogate_gram`: the same field,
    materialized, through :func:`gram_from_field`."""
    return gram_from_field(surrogate_field_reference(seed, n, p, dist,
                                                     device))


def chunk_plan(p, chunk_cols=CHUNK_COLS):
    """The column chunks :func:`surrogate_gram` walks for a p-column
    field: ``(first column, width)`` pairs in order, covering
    ``[0, p_pad)`` once (``p_pad`` = p rounded up to ``COL_PAD``).  Every
    width is a multiple of ``COL_PAD``, at most ``chunk_cols``; the last
    chunk is ragged, its columns ``>= p`` zero in the kernel."""
    if chunk_cols <= 0 or chunk_cols % COL_PAD:
        raise ValueError('chunk_cols must be a positive multiple of {}, got '
                         '{}'.format(COL_PAD, chunk_cols))
    p_pad = -(-p // COL_PAD) * COL_PAD
    return [(c0, min(chunk_cols, p_pad - c0))
            for c0 in range(0, p_pad, chunk_cols)]


def _raw_gram_terms(G, colsum, n):
    """``(G, mu, u, mumu)`` from the raw Gram and the column sums:
    ``u = G 1 / n`` and ``mu . mu = 1^T G 1 / n^2`` are ``X mu`` and
    ``mu . mu`` by exact algebra (``X mu = X X^T 1 / n``)."""
    u = torch.sum(G, dim=1).div_(n)
    return G, colsum.div_(n), u, torch.sum(u) / n


def gram_from_chunks(X, chunk_cols=CHUNK_COLS):
    """Plain version of the kernel's order of work for a materialized
    (n, p) field: f32 ``X_c X_c^T`` summed over the chunks of
    :func:`chunk_plan` in order, the column sums chunk by chunk, and u
    and mu . mu from G as :func:`surrogate_gram` takes them."""
    n, p = X.shape
    G = torch.zeros((n, n), dtype=torch.float32, device=X.device)
    colsum = torch.empty((p,), dtype=torch.float32, device=X.device)
    for c0, width in chunk_plan(p, chunk_cols):
        Xc = X[:, c0:c0 + width].to(torch.float32)
        G += Xc @ Xc.T
        colsum[c0:c0 + width] = Xc.sum(dim=0)
    return _raw_gram_terms(G, colsum, n)


def centered_gram_from_raw(G, u, mumu):
    """Temporal Gram of the centered field from the raw accumulators:
    ``(X - 1 mu^T)(X - 1 mu^T)^T = G - u 1^T - 1 u^T + (mu.mu) 1 1^T``."""
    return G - u[:, None] - u[None, :] + mumu


def surrogate_gram(seed, n, p, dist, device, chunk_cols=CHUNK_COLS):
    """Raw temporal Gram of the generated (n, p) field of ``seed``, the
    field never stored whole: ``(G (n, n), mu (p,), u (n,), mumu ())``,
    f32, as :func:`gram_from_field` defines them.

    The kernel walks the columns in the chunks of :func:`chunk_plan`:
    each chunk is generated once into an (n_pad, chunk_cols) workspace
    (int8 for +-1 draws, else bf16) with its column sums, and K1's kernel
    adds its Gram into ``G`` (f32 sums), chunk after chunk.  Device
    memory beyond the outputs is that workspace and K1's split
    workspace, whatever p is.  ``u`` and ``mu . mu`` come from ``G``
    (:func:`gram_from_chunks` does the same in plain PyTorch).
    """
    device = _gen_device(device, 'surrogate_gram')
    _check_gen(n, p, dist)
    plan = chunk_plan(p, chunk_cols)
    if device.type == 'cpu':
        return surrogate_gram_reference(seed, n, p, dist, device)
    lib = _build.library()
    n_pad = -(-n // ROW_PAD) * ROW_PAD
    pm1 = dist in _PM1_DISTS
    ld = plan[0][1]
    sms = _sm_count(torch.cuda.current_device() if device.index is None
                    else device.index)
    scheds = [schedule(n_pad, width, 1 if pm1 else 2, sms)
              for _, width in plan]
    rows = [v for (c0, width), s in zip(plan, scheds)
            for v in (c0, width, s.kblocks, s.grid, s.dp_tiles,
                      s.split_tiles, s.splits)]
    G = torch.empty((n_pad, n_pad), dtype=torch.float32, device=device)
    colsum = torch.empty((p,), dtype=torch.float32, device=device)
    slot = torch.empty((n_pad, ld), dtype=torch.int8 if pm1
                       else torch.bfloat16, device=device)
    work = torch.empty((max(workspace_tiles(s) for s in scheds), TILE,
                        TILE), dtype=torch.int32, device=device)
    order = order_table(n_pad, sms, device)
    # the chunks share n_pad, so their whole waves and grid
    waves = wave_counter(scheds[0], device)
    err = lib.xmca_surrogate_gram(
        G.data_ptr(), colsum.data_ptr(), slot.data_ptr(), work.data_ptr(),
        order.data_ptr(), data_ptr(waves), n, p, n_pad, ld, int(pm1),
        int(seed) & _MASK32,
        GEN_DISTS.index(dist), (ctypes.c_int * len(rows))(*rows), len(plan),
        _build.stream_of(G))
    _build.check(err, 'surrogate_gram')
    trace.count('launches', 'surrogate_gram')
    return _raw_gram_terms(G[:n, :n], colsum, n)


def project_from_field(X, S):
    """``X^T bf16(S)`` (p, m) f32 of a materialized (n, p) field: ``S``
    is rounded to bf16 as the TPU kernel rounds it, the products are
    summed in f64 and returned as f32."""
    Sb = S.to(torch.bfloat16).to(torch.float64)
    return (X.to(torch.float64).T @ Sb).to(torch.float32)


def surrogate_project_reference(seed, S, n, p, dist, device='cpu'):
    """Plain version of :func:`surrogate_project`."""
    return project_from_field(
        surrogate_field_reference(seed, n, p, dist, device), S)


def surrogate_project(seed, S, n, p, dist, device):
    """``X^T S`` (p, m) f32 for the generated (n, p) field of ``seed``,
    regenerated and never stored; ``S`` (n, m) f32 on ``device`` is
    rounded to bf16 and the products are summed in f32.  For the
    centered field subtract ``mu[:, None] * S.sum(0)[None, :]``."""
    device = _gen_device(device, 'surrogate_project')
    _check_gen(n, p, dist)
    if not isinstance(S, torch.Tensor) or S.dtype != torch.float32:
        raise TypeError('surrogate_project expects S as a float32 tensor')
    if S.ndim != 2 or S.shape[0] != n or S.shape[1] == 0:
        raise ValueError('surrogate_project expects S of shape (n={}, m>0),'
                         ' got {}'.format(n, tuple(S.shape)))
    if S.device.type != device.type or (
            device.index is not None and S.device.index != device.index):
        raise ValueError('S lies on {}, not on {}'.format(S.device, device))
    if device.type == 'cpu':
        return surrogate_project_reference(seed, S, n, p, dist, device)
    lib = _build.library()
    S = S.contiguous()
    m = S.shape[1]
    P = torch.empty((p, m), dtype=torch.float32, device=device)
    err = lib.xmca_surrogate_project(S.data_ptr(), P.data_ptr(), n, p, m,
                                     int(seed) & _MASK32,
                                     GEN_DISTS.index(dist),
                                     _build.stream_of(P))
    _build.check(err, 'surrogate_project')
    trace.count('launches', 'surrogate_project')
    return P

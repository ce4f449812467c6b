"""Symmetric rank-k update ``G = X X^T`` (kernel: ``csrc/syrk.cu``).

The temporal Gram of every Rule-N surrogate field.  The CUDA kernel
computes only the lower-triangle 128x128 tiles and writes each tile and
its mirror, so ``G`` is exactly symmetric.  int8 input accumulates in
int32 (integer-exact); bf16 input in f32.  The f32 result is exact for
integer-valued input while every partial sum stays below 2^24 in
magnitude (``p_pad < 2^24`` for +-1 fields).

Shapes must be pre-padded by :func:`pad_to`: zero rows and columns
contribute nothing and the caller slices them away.

The kernel is persistent: one block per SM walks a fixed list of work
units that :func:`schedule` computes here, where the CPU tests reach it.
Whole waves of tiles run over the full contraction; the tiles left over
after the last whole wave are split along the contraction into
``splits`` pieces, one per block, so the last wave keeps every SM busy.
Each piece writes its partial tile to a workspace that the wrapper
allocates, and a second pass sums the pieces of each tile in a fixed
order (integer-exact for int8, the same bits on every run for bf16).

Tile ``t`` of the work list is entry ``t`` of :func:`tile_order`, a
table of (tile row, tile column) pairs that the kernel reads from the
card (one copy a shape and device, cached).  The order walks bands of
about ``sqrt(sms)`` tile rows column by column, so the ``sms`` tiles of
one wave read about ``2 sqrt(sms)`` row panels of X, not all of them
(:func:`wave_panels` counts them).  From two whole waves on, a wave
barrier (:func:`wave_counter`) keeps the blocks at the same contraction
step, so that the L2 cache serves each panel slice to every tile of the
wave that reads it.
"""
import collections
import functools
import math

import torch

from xmca_tpu_torch.ops import _build
from xmca_tpu_torch.utils import trace

__all__ = ['syrk', 'syrk_reference', 'pad_to', 'schedule', 'work_units',
           'workspace_tiles', 'tile_order', 'wave_panels', 'ROW_PAD',
           'COL_PAD', 'TILE']

ROW_PAD = 128        # n_pad multiple (the kernel's tile is 128 rows)
COL_PAD = 128        # p_pad multiple (128-byte contraction blocks)
TILE = 128           # output tile of the kernel (rows == cols)
KBLOCK_BYTES = 128   # contraction bytes per pipeline stage
MIN_SPLIT_KBLOCKS = 4   # no contraction piece is shorter than this
_INT32_MAX = 2 ** 31 - 1
# float64 bytes of one column block of syrk_reference's exact int8 sum
_REF_BYTES = 1 << 30
# tile rows of a band of tile_order; None: chosen from the SM count
# (chip_smoke.py sets it for its sweep)
_BAND = None
# the wave barrier at two whole waves or more; chip_smoke.py turns it off
# to show what it buys
_WAVE_BARRIER = True

Schedule = collections.namedtuple(
    'Schedule', 'tiles kblocks grid dp_tiles split_tiles splits')
Schedule.__doc__ = """The kernel's work list for one call.

tiles: lower-triangle tiles; kblocks: 128-byte contraction blocks;
grid: blocks launched; dp_tiles: tiles taken whole (block b takes tiles
b, b + grid, ...); split_tiles: the tiles after them, each cut into
``splits`` contraction pieces (block b < split_tiles * splits takes
piece b % splits of tile dp_tiles + b // splits).  Tile t is entry t of
:func:`tile_order`.
"""


def pad_to(n, p):
    """Padded (rows, cols) the kernel accepts for true sizes (n, p)."""
    return -(-n // ROW_PAD) * ROW_PAD, -(-p // COL_PAD) * COL_PAD


def schedule(n_pad, p_pad, elem_bytes, sms):
    """The :class:`Schedule` of an (n_pad, p_pad) input of
    ``elem_bytes``-byte elements on a card with ``sms`` SMs."""
    nb = n_pad // TILE
    tiles = nb * (nb + 1) // 2
    kblocks = p_pad * elem_bytes // KBLOCK_BYTES
    waves, rem = divmod(tiles, sms)
    splits = 1
    if rem:
        splits = max(1, min(sms // rem, kblocks // MIN_SPLIT_KBLOCKS))
    grid = sms if waves else rem * splits
    return Schedule(tiles, kblocks, grid, waves * sms, rem, splits)


def work_units(s, block):
    """The (tile, k0, k1, slot) units of ``block`` in the kernel's order:
    contraction blocks [k0, k1) of ``tile`` (an index into
    :func:`tile_order`); ``slot`` is the workspace tile the piece goes
    to, or -1 for a whole tile written to G."""
    out = [(t, 0, s.kblocks, -1) for t in range(block, s.dp_tiles, s.grid)]
    if block < s.split_tiles * s.splits:
        i = block % s.splits
        out.append((s.dp_tiles + block // s.splits,
                    i * s.kblocks // s.splits,
                    (i + 1) * s.kblocks // s.splits, block))
    return out


def workspace_tiles(s):
    """Partial tiles (TILE x TILE, 4 bytes each) the split pieces need."""
    return s.split_tiles * s.splits


def band_rows(sms):
    """Tile rows of a band: a wave of ``sms`` tiles spans about ``g``
    rows and ``sms / g`` columns, ``g + sms / g`` panels, least at
    ``g = sqrt(sms)``."""
    return max(1, round(math.sqrt(sms)))


def tile_order(n_pad, sms, band=None):
    """The kernel's tiles in order: a list of (tile row, tile column)
    pairs, column <= row, each lower-triangle tile once.

    The ``nb = n_pad / TILE`` tile rows are cut into ``ceil(nb / g)``
    bands of ``g = band or band_rows(sms)`` rows or one fewer (the
    sizes differ by at most one, so no band is a thin remainder).  A
    band of rows [r0, r1) is walked column by column, j = 0 .. r1 - 1,
    each column top down from row max(r0, j): full columns left of the
    band, then the band's own triangle down to the diagonal.  ``g = 1``
    is the row-major order.
    """
    nb = n_pad // TILE
    n_bands = -(-nb // min(band or band_rows(sms), nb))
    base, extra = divmod(nb, n_bands)
    order, r0 = [], 0
    for b in range(n_bands):
        r1 = r0 + base + (b < extra)
        order += [(i, j) for j in range(r1) for i in range(max(r0, j), r1)]
        r0 = r1
    return order


def wave_panels(n_pad, sms, band=None):
    """Distinct row panels of X (tile rows and columns) that each whole
    wave of ``sms`` consecutive tiles of :func:`tile_order` reads."""
    order = tile_order(n_pad, sms, band)
    return [len({p for ij in order[w:w + sms] for p in ij})
            for w in range(0, len(order) - sms + 1, sms)]


@functools.lru_cache(maxsize=None)
def _order_table(n_pad, sms, band, device):
    """:func:`tile_order` as an int32 (tiles, 2) tensor on ``device``,
    copied once a shape."""
    return torch.tensor(tile_order(n_pad, sms, band), dtype=torch.int32,
                        device=device)


def order_table(n_pad, sms, device):
    """The kernel's copy of :func:`tile_order` on ``device``."""
    return _order_table(n_pad, sms, _BAND, device)


def wave_counter(s, device):
    """The kernel's wave counter for schedule ``s``: 4 bytes on
    ``device`` (the launch zeroes them) where ``s`` has two whole waves
    or more, else None (no barrier)."""
    if not _WAVE_BARRIER or s.dp_tiles <= s.grid:
        return None
    return torch.empty(1, dtype=torch.int32, device=device)


def data_ptr(t):
    """``t.data_ptr()``, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def syrk_reference(X):
    """Plain PyTorch ``X X^T`` (f32) with the kernel's contract.

    int8 input is summed exactly (float64 products of int8 values are
    exact far beyond the int32 range the kernel's guard allows), over
    column blocks of at most ``_REF_BYTES`` of float64, and then rounded
    to f32 like the kernel's int32 -> f32 store.  bf16 input is widened
    to f32 and multiplied in f32.
    """
    if X.dtype == torch.int8:
        cols = max(1, _REF_BYTES // (8 * X.shape[0]))
        G = X.new_zeros((X.shape[0], X.shape[0]), dtype=torch.float64)
        for c0 in range(0, X.shape[1], cols):
            Xd = X[:, c0:c0 + cols].to(torch.float64)
            G.addmm_(Xd, Xd.T)
        return G.to(torch.float32)
    Xf = X.to(torch.float32)
    return Xf @ Xf.T


def _validate(X, pm1):
    if not isinstance(X, torch.Tensor) or X.ndim != 2:
        raise TypeError('syrk expects a 2-D torch.Tensor')
    if X.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError('syrk expects int8 or bfloat16, got {}'
                        .format(X.dtype))
    if not X.is_contiguous():
        raise ValueError('syrk expects a contiguous (row-major) tensor')
    n_pad, p_pad = X.shape
    if n_pad % ROW_PAD or p_pad % COL_PAD or n_pad == 0 or p_pad == 0:
        raise ValueError('syrk expects a shape padded by pad_to (rows % {}'
                         ', cols % {}), got {}'.format(ROW_PAD, COL_PAD,
                                                       tuple(X.shape)))
    bound = p_pad if pm1 else p_pad * 127 * 127
    if X.dtype == torch.int8 and bound > _INT32_MAX:
        raise ValueError(
            'int8 syrk may overflow int32: p_pad * max|x|^2 = {} >= 2^31 '
            '(pass pm1=True only for +-1 fields)'.format(bound))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def syrk(X, pm1=False):
    """``X X^T`` (f32, (n_pad, n_pad)) of a padded int8 or bf16 ``X``.

    ``pm1=True`` declares that an int8 ``X`` holds only -1, 0, +1, which
    lifts the int32 overflow guard from ``p_pad * 127^2 < 2^31`` to
    ``p_pad < 2^31``.  A CPU tensor takes :func:`syrk_reference`; a CUDA
    tensor launches the kernel (and counts the launch) or raises.
    """
    _validate(X, pm1)
    if X.device.type == 'cpu':
        return syrk_reference(X)
    if X.device.type != 'cuda':
        raise ValueError('syrk runs on cuda or cpu tensors, not {}'
                         .format(X.device))
    if X.data_ptr() % 16:
        raise ValueError('syrk expects a 16-byte aligned tensor')
    lib = _build.library()
    n_pad, p_pad = X.shape
    index = X.device.index
    sms = _sm_count(torch.cuda.current_device() if index is None
                    else index)
    s = schedule(n_pad, p_pad, X.element_size(), sms)
    order = order_table(n_pad, sms, X.device)
    G = torch.empty((n_pad, n_pad), dtype=torch.float32, device=X.device)
    work = torch.empty((workspace_tiles(s), TILE, TILE), dtype=torch.int32,
                       device=X.device)
    waves = wave_counter(s, X.device)
    err = lib.xmca_syrk(X.data_ptr(), G.data_ptr(), work.data_ptr(),
                        order.data_ptr(), data_ptr(waves), n_pad, p_pad,
                        int(X.dtype == torch.int8), s.kblocks, s.grid,
                        s.dp_tiles, s.split_tiles, s.splits,
                        _build.stream_of(X))
    _build.check(err, 'syrk')
    trace.count('launches', 'syrk')
    return G

"""Symmetric rank-k update ``G = X X^T`` (kernel: ``csrc/syrk.cu``).

The temporal Gram of every Rule-N surrogate field.  The CUDA kernel
computes only the lower-triangle 64x64 tiles and writes each tile and
its mirror, so ``G`` is exactly symmetric.  int8 input accumulates in
int32 (integer-exact); bf16 input in f32.  The f32 result is exact for
integer-valued input while every partial sum stays below 2^24 in
magnitude (``p_pad < 2^24`` for +-1 fields).

Shapes must be pre-padded by :func:`pad_to`: zero rows and columns
contribute nothing and the caller slices them away.
"""
import torch

from xmca_tpu_torch.ops import _build

__all__ = ['syrk', 'syrk_reference', 'pad_to', 'ROW_PAD', 'COL_PAD']

ROW_PAD = 128        # n_pad multiple (the kernel's tile is 64 rows)
COL_PAD = 128        # p_pad multiple (128-byte contraction chunks)
_INT32_MAX = 2 ** 31 - 1


def pad_to(n, p):
    """Padded (rows, cols) the kernel accepts for true sizes (n, p)."""
    return -(-n // ROW_PAD) * ROW_PAD, -(-p // COL_PAD) * COL_PAD


def syrk_reference(X):
    """Plain PyTorch ``X X^T`` (f32) with the kernel's contract.

    int8 input is summed exactly (float64 products of int8 values are
    exact far beyond the int32 range the kernel's guard allows) and then
    rounded to f32 like the kernel's int32 -> f32 store.  bf16 input is
    widened to f32 and multiplied in f32.
    """
    if X.dtype == torch.int8:
        Xd = X.to(torch.float64)
        return (Xd @ Xd.T).to(torch.float32)
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
    G = torch.empty((n_pad, n_pad), dtype=torch.float32, device=X.device)
    err = lib.xmca_syrk(X.data_ptr(), G.data_ptr(), n_pad, p_pad,
                        int(X.dtype == torch.int8), _build.stream_of(X))
    _build.check(err, 'syrk')
    _build.LAUNCHES['syrk'] += 1
    return G

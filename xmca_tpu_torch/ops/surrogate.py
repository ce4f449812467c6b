"""+-1 surrogate fields for Rule-N ensembles (kernel: ``csrc/sign_field.cu``).

:func:`sign_field_sums` draws one masked +-1 int8 field in the padded
layout :func:`xmca_tpu_torch.ops.syrk.syrk` reads, plus its int32
column sums, in one pass.  The random bits come from Philox4x32-10
(Salmon et al. 2011, "Parallel random numbers: as easy as 1, 2, 3"):

* key ``(seed ^ 0x53474E53, SIGN_STREAM)``; the second key word names
  the draw family, so later draw kernels take other stream ids and
  never reuse these bits;
* counter ``(row, column group, 0, 0)`` per 128-column group;
* output word ``w``, bit ``b`` -> column ``128 * group + 32 * w + b``;
  bit 1 is +1, bit 0 is -1; rows ``>= n`` and columns ``>= p`` are 0.

:func:`sign_field_sums_reference` is the same function in plain
PyTorch (int64 arithmetic on 32-bit lanes), so the kernel and the plain
version give the same bits on the same seed.
"""
import torch

from xmca_tpu_torch.ops import _build
from xmca_tpu_torch.ops.syrk import COL_PAD, ROW_PAD

__all__ = ['sign_field_sums', 'sign_field_sums_reference', 'philox4x32_10',
           'SIGN_SALT', 'SIGN_STREAM']

SIGN_SALT = 0x53474E53           # 'SGNS', the TPU kernel's salt
SIGN_STREAM = 0
GROUP = 128                      # columns per Philox output
_MASK32 = 0xFFFFFFFF
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
    colsum int32 (p_pad,))`` with identical bits."""
    _check_shape(n, p, n_pad, p_pad)
    groups = p_pad // GROUP
    rows = torch.arange(n_pad, dtype=torch.int64, device=device)
    grp = torch.arange(groups, dtype=torch.int64, device=device)
    c0 = rows[:, None].expand(n_pad, groups)
    c1 = grp[None, :].expand(n_pad, groups)
    zero = torch.zeros((n_pad, groups), dtype=torch.int64, device=device)
    words = philox4x32_10(c0, c1, zero, zero,
                          (int(seed) & _MASK32) ^ SIGN_SALT, SIGN_STREAM)
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    bits = torch.stack(
        [((w[:, :, None] >> shifts) & 1).to(torch.int8) for w in words],
        dim=2,
    )                                          # (n_pad, groups, 4, 32)
    X = (bits * 2 - 1).reshape(n_pad, p_pad)
    X[n:] = 0
    X[:, p:] = 0
    return X, X.sum(dim=0, dtype=torch.int32)


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
    _build.LAUNCHES['sign_field_sums'] += 1
    return X, colsum

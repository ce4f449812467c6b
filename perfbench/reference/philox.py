"""A frozen copy of the +-1 surrogate draw, in plain PyTorch.

Philox4x32-10 (Salmon et al. 2011) on int64 tensors that hold 32-bit
lanes.  One +-1 field of seed ``seed``: key ``(seed ^ 0x53474E53, 0)``,
counter ``(row, column group, 0, 0)`` for each group of 128 columns;
output word ``w``, bit ``b`` gives column ``128 group + 32 w + b``, bit 1
is +1 and bit 0 is -1.  This is the bit layout the package documents for
its +-1 draws; nothing of the package is imported here.
"""
import torch

SIGN_SALT = 0x53474E53
SIGN_STREAM = 0
GROUP = 128
MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
# int64 bit lanes drawn at once (rows x groups x 128)
_LANES = 1 << 27


def _mulhilo(m, c):
    """32-bit (hi, lo) of ``m * c`` for a 32-bit constant and int64 lanes,
    split into 16-bit halves so no partial product overflows."""
    t1 = m * (c & 0xFFFF)
    t2 = m * (c >> 16)
    hi = (t2 + (t1 >> 16)) >> 16
    lo = (((t2 & 0xFFFF) << 16) + t1) & MASK32
    return hi & MASK32, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """The four 32-bit output lanes of Philox4x32-10."""
    k0 &= MASK32
    k1 &= MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & MASK32
        k1 = (k1 + _W1) & MASK32
    return c0, c1, c2, c3


def pm1_field(seed, n, p, device='cpu'):
    """The (n, p) +-1 field of ``seed`` (taken mod 2^32) as int8."""
    groups = -(-p // GROUP)
    step = max(1, _LANES // (GROUP * groups))
    grp = torch.arange(groups, dtype=torch.int64, device=device)
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    out = torch.empty((n, p), dtype=torch.int8, device=device)
    key = (int(seed) & MASK32) ^ SIGN_SALT
    for r0 in range(0, n, step):
        rows = torch.arange(r0, min(r0 + step, n), dtype=torch.int64,
                            device=device)
        c0 = rows[:, None].expand(len(rows), groups)
        c1 = grp[None, :].expand(len(rows), groups)
        zero = torch.zeros_like(c0)
        words = philox4x32_10(c0, c1, zero, zero, key, SIGN_STREAM)
        bits = torch.stack([(w[:, :, None] >> shifts) & 1 for w in words],
                           dim=2)                  # (rows, groups, 4, 32)
        vals = (bits * 2 - 1).to(torch.int8).reshape(len(rows), -1)
        out[r0:r0 + len(rows)] = vals[:, :p]
    return out

"""Varimax and Promax with the reference's entry points
(xmca/tools/rotation.py): the port's counterpart of
``xmca_tpu/tools/rotation.py``.  Numpy in, numpy out, ``RuntimeError``
when the iteration does not converge; the fixed point runs in
:mod:`xmca_tpu_torch.core.rotation` on ``device`` (``'cuda'`` unless the
caller names another), at the array's precision.
"""
import numpy as np
import torch

from xmca_tpu_torch.core import rotation as _core
from xmca_tpu_torch.utils.device import resolve_device

_NON_CONVERGENCE_MSG = (
    'Rotation process did not converge. Try decreasing the tolerance. '
    'Invalid NaN entries also might be a problem.'
)


def _np(x):
    return x.cpu().resolve_conj().numpy()


def varimax(A, gamma=1, maxIter=1000, tol=1e-8, device='cuda'):
    """Orthogonal Varimax rotation with Kaiser normalization.

    Returns ``(B, R)``: the rotated matrix and the rotation matrix.
    """
    A = torch.as_tensor(np.asarray(A), device=resolve_device(device))
    B, R, converged, _ = _core.varimax(A, gamma=gamma, max_iter=int(maxIter),
                                       tol=tol)
    if not converged:
        raise RuntimeError(_NON_CONVERGENCE_MSG)
    return _np(B), _np(R)


def promax(A, power=1, maxIter=1000, tol=1e-8, device='cuda'):
    """Oblique Promax rotation (``power=1`` is Varimax).

    Returns ``(B, R, phi)``: the rotated matrix, the rotation matrix and
    the correlation matrix of the rotated components.
    """
    A = np.asarray(A)
    n, p = A.shape
    if p < 2:
        # the reference's degenerate branch (an identity of the rows' size)
        print('Cannot rotate 1 PC. No rotation performed.')
        return A, np.eye(n), A.conjugate().T @ A
    B, R, phi, converged, _ = _core.promax(
        torch.as_tensor(A, device=resolve_device(device)), power=int(power),
        max_iter=int(maxIter), tol=tol)
    if not converged:
        raise RuntimeError(_NON_CONVERGENCE_MSG)
    return _np(B), _np(R), _np(phi)

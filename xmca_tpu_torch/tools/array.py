"""Array helpers with the reference's entry points (xmca/tools/array.py):
the port's counterpart of ``xmca_tpu/tools/array.py``, numpy in and numpy
out, with the NaN-column helpers of :mod:`xmca_tpu_torch.utils.nan`."""
import numpy as np

from xmca_tpu_torch.utils.nan import (  # noqa: F401
    get_nan_cols, has_nan_time_steps, remove_mean, remove_nan_cols)


def pearsonr(x, y):
    """Column-wise Pearson correlation of two 2-D arrays and its
    two-sided p-values (the beta distribution on [-1, 1])."""
    if x.shape[0] != y.shape[0]:
        raise ValueError('Time dimensions are different.')
    n = x.shape[0]
    xc = x - x.mean(axis=0)
    yc = y - y.mean(axis=0)
    r = (xc.conj().T @ yc) / np.outer(
        np.linalg.norm(xc, axis=0), np.linalg.norm(yc, axis=0))
    from scipy.special import betainc
    a = n / 2.0 - 1.0
    p = 2 * betainc(a, a, np.clip((1.0 - np.abs(r)) / 2.0, 0, 1))
    return r, p


def block_bootstrap(arr, axis=0, block_size=1, replace=True):
    """(Moving-block) bootstrap resample of a 2-D array along ``axis``,
    drawn from numpy's global generator as the reference draws it; the
    device ensembles draw theirs in :mod:`xmca_tpu_torch.stats`."""
    if axis == 1:
        arr = arr.T
    elif axis != 0:
        raise ValueError('{:} not a valid axis. either 0 or 1.'.format(axis))
    n_obs = arr.shape[0]
    try:
        block_arr = arr.reshape(-1, block_size, arr.shape[1])
    except ValueError as err:
        raise ValueError(
            'Length of data array ({:}) must be a multiple of block size '
            '{:}'.format(n_obs, block_size)
        ) from err
    n_samples = block_arr.shape[0]
    idx = np.random.choice(n_samples, size=n_samples, replace=replace)
    new_arr = block_arr[idx].reshape(arr.shape)
    return new_arr.T if axis == 1 else new_arr

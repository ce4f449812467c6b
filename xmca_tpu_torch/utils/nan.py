"""Host-side NaN-column helpers: the port's own copy of
``xmca_tpu/utils/nan.py`` (the port imports nothing of the JAX package),
re-exported by :mod:`xmca_tpu_torch.tools.array` as the reference's
``xmca/tools/array.py`` exports them.
"""
import numpy as np


def get_nan_cols(arr):
    """Boolean index of the columns (axis 1) that hold a NaN."""
    return np.isnan(arr).any(axis=0)


def remove_nan_cols(arr):
    """Drop the columns that hold a NaN."""
    return arr[:, ~get_nan_cols(arr)]


def has_nan_time_steps(array):
    """True if any time step (a row along axis 0) is entirely NaN."""
    return bool(np.isnan(array).all(axis=tuple(range(1, array.ndim))).any())


def remove_mean(arr):
    """Remove the temporal (axis 0) mean."""
    with np.errstate(invalid='ignore'):
        return arr - arr.mean(axis=0)

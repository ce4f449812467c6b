"""The port's reference-parity helpers (``tools/rotation.py``,
``tools/array.py``, ``utils/nan.py``) against the JAX package's, on CPU:
the rotations in float64 to 1e-8 after a sign per column (varimax fixes
a rotation only up to one), their non-convergence ``RuntimeError`` and
the single-column branch; ``pearsonr`` to 1e-12; ``block_bootstrap``
from the same ``np.random.seed`` identical; the NaN helpers identical.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_array_equal

from xmca_tpu.tools import array as jarr
from xmca_tpu.tools import rotation as jrot
from xmca_tpu_torch.tools import array as tarr
from xmca_tpu_torch.tools import rotation as trot

DEV = 'cpu'


def _signs(got, ref):
    """``got`` with each column's sign that best matches ``ref``."""
    return got * np.sign(np.sum(got * ref, axis=0))[None, :]


def _loadings(seed, n=60, p=5, complex_=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, p)) * np.linspace(3, 1, p)[None, :]
    if complex_:
        A = A + 1j * rng.standard_normal((n, p))
    return A


@pytest.mark.parametrize('complex_', [False, True])
def test_varimax_matches_jax(complex_):
    A = _loadings(0, complex_=complex_)
    B, R = trot.varimax(A, device=DEV)
    Bj, Rj = jrot.varimax(A)
    assert B.dtype == Bj.dtype
    if complex_:
        # a complex column is fixed up to a unit factor
        ph = np.sum(np.conj(B) * Bj, axis=0)
        B, R = B * (ph / np.abs(ph)), R * (ph / np.abs(ph))
    else:
        R, B = _signs(R, Rj), _signs(B, Bj)
    assert_allclose(B, Bj, atol=1e-8)
    assert_allclose(R, Rj, atol=1e-8)


@pytest.mark.parametrize('power', [1, 3])
def test_promax_matches_jax(power):
    A = _loadings(1)
    B, R, phi = trot.promax(A, power=power, device=DEV)
    Bj, Rj, phij = jrot.promax(A, power=power)
    s = np.sign(np.sum(B * Bj, axis=0))
    assert_allclose(B * s, Bj, atol=1e-8)
    assert_allclose(R * s, Rj, atol=1e-8)
    assert_allclose(phi * np.outer(s, s), phij, atol=1e-8)


@pytest.mark.parametrize('fn', ['varimax', 'promax'])
def test_rotation_non_convergence_raises_as_jax(fn):
    A = _loadings(2)
    with pytest.raises(RuntimeError) as ref:
        getattr(jrot, fn)(A, maxIter=1)
    with pytest.raises(RuntimeError) as got:
        getattr(trot, fn)(A, maxIter=1, device=DEV)
    assert str(got.value) == str(ref.value)


def test_promax_single_column_as_jax(capsys):
    A = np.random.default_rng(3).standard_normal((10, 1))
    got = trot.promax(A, device=DEV)
    out = capsys.readouterr().out
    ref = jrot.promax(A)
    assert out == capsys.readouterr().out
    for g, r in zip(got, ref):
        assert_array_equal(g, r)


def test_pearsonr_matches_jax():
    rng = np.random.default_rng(4)
    x, y = rng.standard_normal((80, 4)), rng.standard_normal((80, 3))
    for g, r in zip(tarr.pearsonr(x, y), jarr.pearsonr(x, y)):
        assert_allclose(g, r, rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match='Time dimensions'):
        tarr.pearsonr(x, y[:10])


@pytest.mark.parametrize('axis,block_size,replace', [
    (0, 4, True), (0, 4, False), (1, 5, True), (0, 1, True)])
def test_block_bootstrap_matches_jax(axis, block_size, replace):
    arr = np.random.default_rng(5).standard_normal((24, 10))
    np.random.seed(11)
    got = tarr.block_bootstrap(arr, axis=axis, block_size=block_size,
                               replace=replace)
    np.random.seed(11)
    ref = jarr.block_bootstrap(arr, axis=axis, block_size=block_size,
                               replace=replace)
    assert_array_equal(got, ref)


@pytest.mark.parametrize('kw', [dict(block_size=7), dict(axis=2)])
def test_block_bootstrap_errors_as_jax(kw):
    arr = np.ones((24, 5))
    with pytest.raises(ValueError) as ref:
        jarr.block_bootstrap(arr, **kw)
    with pytest.raises(ValueError) as got:
        tarr.block_bootstrap(arr, **kw)
    assert str(got.value) == str(ref.value)


def test_nan_helpers_match_jax():
    arr = np.arange(20.).reshape(4, 5)
    arr[2, 1] = arr[:, 3] = np.nan
    for name in ('get_nan_cols', 'remove_nan_cols', 'remove_mean'):
        assert_array_equal(getattr(tarr, name)(arr), getattr(jarr, name)(arr))
    steps = arr.copy()
    steps[1] = np.nan
    for a in (arr, steps):
        assert tarr.has_nan_time_steps(a) == jarr.has_nan_time_steps(a)

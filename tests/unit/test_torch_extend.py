"""Boundary extension of the port (``core/theta.py``, ``core/preprocess.py``)
against the JAX package on CPU, float64.

The same numpy-seeded fields go through both packages' functions: the exp
forecast, the seasonal component (even and odd period, positive and
mixed-sign columns), the SES sweep and fit, the theta forecast (period 1,
12 and a record shorter than two periods), ``extend_field`` and the
extended ``complexify`` agree to 1e-9 of the result's largest entry.  The
port's theta is also held to the per-series oracle
(``tests/oracles/theta_oracle.py``) at the JAX package's thresholds
(``tests/integration/test_theta_parity.py``), on synthetic red-noise
data: the sst/prcp fixtures are not mounted here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.oracles.theta_oracle import theta_forecast_series
from xmca_tpu.core import preprocess as jpre
from xmca_tpu.core import theta as jtheta
from xmca_tpu_torch.core import preprocess as tpre
from xmca_tpu_torch.core import theta as ttheta

TOL = 1e-9


def _field(T=96, p=24, seed=0, positive=None):
    """A seasonal (period 12) field with trends and noise; the columns in
    ``positive`` are shifted strictly positive (multiplicative
    deseasonalization), the others have mixed signs."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    f = (np.sin(2 * np.pi * t / 12)[:, None] * rng.standard_normal(p)
         + 0.01 * t[:, None] * rng.standard_normal(p)
         + 0.3 * rng.standard_normal((T, p)))
    if positive is not None:
        f[:, positive] += 6.0
    return f


def _close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize('period', [1.0, 5.0, 40.0])
def test_exp_forecast_matches_jax(period):
    f = _field()
    _close(tpre.exp_forecast(torch.as_tensor(f), period),
           jpre.exp_forecast(jnp.asarray(f), period))


@pytest.mark.parametrize('period', [12, 7])
@pytest.mark.parametrize('positive', [slice(None), slice(0, 10)],
                         ids=['positive', 'mixed'])
def test_seasonal_component_matches_jax(period, positive):
    f = _field(positive=positive)
    got = ttheta._seasonal_component(torch.as_tensor(f), period)
    ref = jtheta._seasonal_component(jnp.asarray(f), period)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_moving_average_in_blocks(monkeypatch):
    """The trend formed in several banded blocks equals the one-block
    trend (and JAX's seasonal component)."""
    f = _field(T=130, positive=slice(0, 5))
    whole = ttheta._seasonal_component(torch.as_tensor(f), 12)
    monkeypatch.setattr(ttheta, '_BAND_ROWS', 16)
    blocks = ttheta._seasonal_component(torch.as_tensor(f), 12)
    ref = jtheta._seasonal_component(jnp.asarray(f), 12)
    for got, want in zip(blocks[:2], whole[:2]):
        _close(got, want, 1e-12)
    _close(blocks[0], ref[0])


@pytest.mark.parametrize('per_column', [False, True])
def test_ses_sweep_matches_jax(per_column):
    """The sweep at a shared grid and at a grid per column (the
    refinement's layout; the JAX package inlines that scan in
    ``_ses_fit``, so the per-column case is held to JAX's sweep run
    column by column on each column's grid)."""
    f = _field(p=6)
    rng = np.random.default_rng(3)
    if not per_column:
        alphas = np.linspace(0.02, 0.98, 9)
        sse, l_T = ttheta._ses_sweep(torch.as_tensor(f),
                                     torch.as_tensor(alphas))
        ref = jtheta._ses_sweep(jnp.asarray(f), jnp.asarray(alphas))
        _close(sse, ref[0])
        _close(l_T, ref[1])
        return
    alphas = rng.uniform(0.05, 0.95, (5, f.shape[1]))
    sse, l_T = ttheta._ses_sweep(torch.as_tensor(f), torch.as_tensor(alphas))
    for j in range(f.shape[1]):
        ref = jtheta._ses_sweep(jnp.asarray(f[:, j:j + 1]),
                                jnp.asarray(alphas[:, j]))
        _close(sse[:, j:j + 1], ref[0])
        _close(l_T[:, j:j + 1], ref[1])


def test_ses_fit_matches_jax():
    f = _field(p=30)
    alpha, l_T = ttheta._ses_fit(torch.as_tensor(f))
    ref_alpha, ref_l = jtheta._ses_fit(jnp.asarray(f))
    np.testing.assert_array_equal(alpha.numpy(), np.asarray(ref_alpha))
    _close(l_T, ref_l)


@pytest.mark.parametrize('period,T', [(1, 96), (12, 96), (12, 20),
                                      (7, 60)],
                         ids=['period1', 'period12', 'short', 'period7'])
def test_theta_forecast_matches_jax(period, T):
    f = _field(T=T, positive=slice(0, 8))
    got = ttheta.theta_forecast(torch.as_tensor(f), T, period)
    ref = jtheta.theta_forecast(jnp.asarray(f), steps=T, period=period,
                                theta=20.0)
    _close(got, ref)


@pytest.mark.parametrize('method,period', [('exp', 3), ('theta', 12)])
def test_extend_field_matches_jax(method, period):
    f = _field()
    _close(tpre.extend_field(torch.as_tensor(f), method, period),
           jpre.extend_field(jnp.asarray(f), method, period))


def test_extend_field_refuses_other_methods():
    f = torch.zeros((8, 2), dtype=torch.float64)
    with pytest.raises(ValueError) as ref:
        jpre.extend_field(jnp.zeros((8, 2)), 'foo', 1)
    with pytest.raises(ValueError) as got:
        tpre.extend_field(f, 'foo', 1)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize('extend,period', [('exp', 1), ('exp', 6),
                                           ('theta', 12), ('theta', 1)])
def test_complexify_extend_matches_jax(extend, period):
    f = _field(T=64, p=20, seed=4, positive=slice(0, 4))
    f = f - f.mean(axis=0)
    got = tpre.complexify(torch.as_tensor(f), extend=extend, period=period)
    ref = jpre.complexify(jnp.asarray(f), extend=extend, period=period)
    assert got.is_complex()
    _close(got, ref)


def _red_field(T=240, p=16, seed=9):
    """Persistent (AR(1), 0.98) monthly series with a seasonal cycle, as
    geophysical fields are; six columns strictly positive.  White noise
    would put many SES optima below the grid's 0.02, where the grid and
    the oracle's optimizer part (in both packages alike)."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((T, p))
    x = np.zeros((T, p))
    for i in range(1, T):
        x[i] = 0.98 * x[i - 1] + e[i]
    t = np.arange(T)
    f = (2 * np.sin(2 * np.pi * t / 12)[:, None] * rng.standard_normal(p)
         + 0.5 * x)
    f[:, :6] += 20.0
    return f


@pytest.mark.parametrize('period', [12, 1])
def test_theta_matches_oracle(period):
    """The port's theta against the per-series oracle at the JAX
    package's thresholds: max deviation over the column's std < 3e-3,
    median < 1e-4."""
    f = _red_field()
    n = f.shape[0]
    got = ttheta.theta_forecast(torch.as_tensor(f), n, period).numpy()
    oracle = np.stack([theta_forecast_series(f[:, j], n, period)
                       for j in range(f.shape[1])], axis=1)
    dev = np.max(np.abs(got - oracle), axis=0) / f.std(axis=0)
    assert dev.max() < 3e-3
    assert np.median(dev) < 1e-4

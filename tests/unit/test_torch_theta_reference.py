"""The port's theta extension against the benchmark's plain reference
(``perfbench/reference/theta.py``), and one call of the benchmark's
extended-bootstrap driver (``perfbench/drivers/boot_extended.py``) on
the CPU.

The reference is written from the method's description (the SES sweeps
as matrix products, the analytic signal as a closed-form circulant), so
it shares no arithmetic with ``core/theta.py`` beyond the grid.  In
float64 both pick the same grid points and agree to roundoff: within
1e-10 of each column's standard deviation.
"""
import numpy as np
import pytest
import scipy.signal
import torch

from perfbench.reference import theta as ref
from xmca_tpu_torch.core import preprocess as tpre
from xmca_tpu_torch.core import theta as ttheta

TOL = 1e-10


def _field(T, p=32, seed=0, positive=10):
    """Persistent (AR(1), 0.9) monthly series with a seasonal cycle and a
    trend; the first ``positive`` columns strictly positive
    (multiplicative deseasonalization), the rest signed (additive)."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((T, p))
    x = np.zeros((T, p))
    for i in range(1, T):
        x[i] = 0.9 * x[i - 1] + e[i]
    t = np.arange(T)
    f = (2 * np.sin(2 * np.pi * t / 12)[:, None] * rng.standard_normal(p)
         + 0.02 * t[:, None] * rng.standard_normal(p) + 0.5 * x)
    f[:, :positive] += 20.0
    return torch.as_tensor(f)


@pytest.mark.parametrize('period', [1, 12])
@pytest.mark.parametrize('T', [48, 120])
def test_theta_forecast_matches_reference(T, period):
    y = _field(T, seed=T + period)
    assert bool((y[:, :10] > 0).all()) and bool((y[:, 10:] < 0).any())
    got = ttheta.theta_forecast(y, T, period)
    want = ref.theta_forecast(y, T, period)
    dev = (got - want).abs().amax(dim=0) / y.std(dim=0)
    assert float(dev.max()) < TOL


def test_complexify_extend_matches_reference():
    y = _field(64, p=20, seed=4, positive=4)
    y = y - y.mean(dim=0)
    got = tpre.complexify(y, extend='theta', period=12)
    want = ref.extended_signal(y, 12)
    assert got.is_complex() and got.shape == want.shape
    dev = (got - want).abs().amax(dim=0) / y.std(dim=0)
    assert float(dev.max()) < TOL


@pytest.mark.parametrize('N', [30, 31])
def test_analytic_operator_is_scipys_hilbert(N):
    x = np.random.default_rng(N).standard_normal((N, 5))
    A = ref.analytic_rows(N, slice(0, N), torch.float64, 'cpu')
    got = (A @ torch.as_tensor(x).to(A.dtype)).numpy()
    np.testing.assert_allclose(got, scipy.signal.hilbert(x, axis=0),
                               rtol=0, atol=1e-12)


def test_ses_sweep_is_the_recursion():
    """The matrix form of one sweep against SES run step by step from the
    closed-form best initial level."""
    y = _field(40, p=6, seed=3)
    alphas = torch.tensor([0.05, 0.3, 0.9], dtype=torch.float64)
    sse, l_T = ref.ses_sse(y, alphas)
    for g, a in enumerate(alphas.tolist()):
        for j in range(y.shape[1]):
            s = y[:, j].numpy()
            # errors are affine in l0: e = c - h l0
            c, h, lev, hl = [], [], 0.0, 1.0
            for v in s:
                c.append(v - lev)
                h.append(hl)
                lev += a * (v - lev)
                hl *= 1.0 - a
            c, h = np.array(c), np.array(h)
            l0 = (h @ c) / (h @ h)
            e = c - h * l0
            assert float(sse[g, j]) == pytest.approx(e @ e, rel=1e-10)
            assert float(l_T[g, j]) == pytest.approx(lev + hl * l0,
                                                     rel=1e-10)


# the program (float32) against the reference (float64) reads 2e-6 of a
# rotated variance here, and up to 7e-5 on the harness's 64 x 8 x 16
# copy of the cell (float32 roundoff and a varimax stopping at its 100
# eps floor); 1e-3 leaves ten times that, while a varimax a step apart
# or a wrong mode reads 1e-2 and more
BOOT_GAP_TINY = 1e-3
# the singular values ahead of the rotation, their widest gap over the
# leading value, read 3e-7 to 7e-7 on both copies (float32 Grams of 48
# or 64 steps); 1e-5 leaves over ten times that, and no varimax step
# moves them
SVALS_GAP_TINY = 1e-5
SEED = 2 ** 31 + 23


def _tiny(seed=SEED):
    """The cell's spec and its calls at 48 x 12 x 16 on the CPU, set up
    (fields, the extended fit in the warm-up) and one window call made."""
    from perfbench.calls import Calls
    from perfbench.harness import Spec
    spec = Spec('era5_025_mon480.theta_boot')
    spec.config.update(n_obs=48, n_lat=12, n_lon=16)
    calls = Calls(spec.config, spec.traffic, seed, 'cpu')
    calls.setup()
    calls.call(0)
    return spec, calls


def _compare(spec, calls, seed=SEED, samples=2):
    from perfbench import checks
    return checks.compare(calls, calls.records, seed,
                          dict(spec.check, samples=samples), 'cpu')


def test_boot_extended_call_is_within_its_limit():
    spec, calls = _tiny()
    assert spec.traffic['kwargs']['block_size'] == 12
    assert spec.traffic['runs_per_call'] == 2
    assert calls.model._analysis['extend'] == 'theta'
    (rec,) = calls.records
    assert rec['out'].shape == (10, 2) and np.all(rec['out'] > 0)
    assert rec['svals'].shape == (10, 2) and np.all(rec['svals'] > 0)
    numbers, notes = _compare(spec, calls)
    assert notes == []
    assert 0 < numbers['boot_gap'] < BOOT_GAP_TINY
    assert 0 < numbers['svals_gap'] < SVALS_GAP_TINY


def test_an_answer_altered_where_it_is_produced_is_not_correct(
        monkeypatch):
    """Each run's leading rotated variance made 10% larger as the
    bootstrap returns it: ``boot_gap`` is over the cell's limit."""
    from xmca_tpu_torch.stats import significance as sig
    orig = sig.bootstrap_spectra

    def boot(*a, **kw):
        spectra, conv = orig(*a, **kw)
        spectra = spectra.copy()
        spectra[:, 0] *= 1.1
        return spectra, conv
    monkeypatch.setattr(sig, 'bootstrap_spectra', boot)
    spec, calls = _tiny()
    numbers, _ = _compare(spec, calls)
    assert numbers['boot_gap'] > spec.check['limits']['boot_gap']


def test_a_solve_a_thousandth_off_is_caught_by_the_singular_values(
        monkeypatch):
    """Each run's singular values 0.1% larger where the rotation takes
    them: the rotated variances move by as much, under ``boot_gap``'s
    limit, and ``svals_gap`` is over its own."""
    from xmca_tpu_torch.core import fastpath
    orig = fastpath._rotated_variance

    def rotated(Vl, Vr, s, *a, **kw):
        return orig(Vl, Vr, s * (1 + 1e-3), *a, **kw)
    monkeypatch.setattr(fastpath, '_rotated_variance', rotated)
    spec, calls = _tiny()
    numbers, notes = _compare(spec, calls)
    limits = spec.check['limits']
    assert notes == []
    assert numbers['boot_gap'] < limits['boot_gap']
    assert numbers['svals_gap'] > limits['svals_gap']


def test_boot_extended_never_fits_in_a_window_call():
    from perfbench.calls import Calls
    from perfbench.harness import Spec
    spec = Spec('era5_025_mon480.theta_boot')
    spec.config.update(n_obs=48, n_lat=12, n_lon=16)
    calls = Calls(spec.config, spec.traffic, 2 ** 31 + 29, 'cpu')
    calls.make_fields()
    with pytest.raises(RuntimeError):
        calls.call(0)


def test_boot_extended_warms_up_on_one_run():
    """The warm-up call fits and makes one run (a run's shapes are the
    same in every call); the calls after it make the traffic's two."""
    from perfbench.calls import WARMUP, Calls, derive
    from perfbench.harness import Spec
    spec = Spec('era5_025_mon480.theta_boot')
    spec.config.update(n_obs=48, n_lat=12, n_lon=16)
    calls = Calls(spec.config, spec.traffic, 2 ** 31 + 31, 'cpu')
    calls.make_fields()
    warm = derive(calls.seed, WARMUP, 0)
    units, (rec,) = calls.driver.call(calls, warm)
    assert units == 1 and rec['svals'].shape == (10, 1)
    assert calls.driver.call(calls, warm)[0] == 2


def test_a_package_that_keeps_no_singular_values_fails_before_the_fit(
        monkeypatch):
    from perfbench.calls import Calls
    from perfbench.harness import Spec
    from xmca_tpu_torch.utils import trace
    monkeypatch.delattr(trace, 'keeping')
    spec = Spec('era5_025_mon480.theta_boot')
    spec.config.update(n_obs=48, n_lat=12, n_lon=16)
    calls = Calls(spec.config, spec.traffic, 2 ** 31 + 37, 'cpu')
    with pytest.raises(RuntimeError, match='keeps no singular values'):
        calls.setup()
    assert calls.model is None

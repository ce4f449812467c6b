"""The long-record route of the port against the benchmark's plain
reference (``perfbench/reference/mca.py``), on the CPU.

A record longer than ``api.array._HILBERT_MATMUL_MAX_N`` steps (8192)
leaves the analytic fold: its truncated complexified solve builds Z by
FFT and solves the complex fields, while Rule-N folds each surrogate's
Gram with the n x n Hilbert operator.  Here the threshold is patched down
to 64 so that a 150-step record takes that route ('fft'); unpatched, the
same record takes the fold ('fold').  The fields are the benchmark's
(``perfbench/fields.py``) on a 12 x 24 grid, float32 as the deployment
states; the pipeline is the benchmark's (``set_solver(truncate=10)``,
``normalize``, ``apply_coslat``, ``solve(complexify=True)``,
``rotate(10)``), and the reference runs it in float64 from the same
seeds.

Tolerances (relative), each from the float32 arithmetic of the port;
the largest gaps over five seeds on both routes are in brackets:

* singular values 2e-5 [6.7e-6]: f32 products over 288 columns and a
  150 x 150 Cholesky reduction;
* the exact total (the nuclear norm) 2e-6 [2.5e-7];
* the rotated total, the sum of the rotated variances, 1e-5 [1.0e-6];
  each rotated variance 5e-3 [1.4e-3]: varimax stops once its criterion
  changes by less than 100 eps of float32 (1.2e-5) in both, and a
  criterion flat to that leaves each mode's variance free to about its
  square root;
* a Rule-N run's spectrum over its sum 5e-5 [3.7e-6], and its sum
  rescaled against the reference model's rotated total 1e-5 [1.1e-6].
"""
import numpy as np
import pytest
import torch

import xmca_tpu_torch.api.array as tarr
from perfbench.fields import coords, host_fields
from perfbench.reference import mca
from xmca_tpu_torch.xarray import DataArray, xMCA

N_OBS, N_LAT, N_LON, N_ROT = 150, 12, 24, 10
SEED, SOLVER_SEED, RULE_N_SEED = 2 ** 31 + 17, 17, 2 ** 31 + 22
CONFIG = dict(n_obs=N_OBS, n_lat=N_LAT, n_lon=N_LON, lat_range=[-90, 90],
              lon_range=[0, 359])
SVALS_TOL, TOTAL_TOL, ROT_TOTAL_TOL, VARIANCE_TOL = 2e-5, 2e-6, 1e-5, 5e-3
RUN_GAP_TOL, SCALE_GAP_TOL = 5e-5, 1e-5
# the threshold each route is reached at: below the record, or the port's
THRESHOLD = {'fft': 64, 'fold': tarr._HILBERT_MATMUL_MAX_N}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


@pytest.fixture(scope='module')
def inputs():
    """The host fields, the grid's coordinates and the reference's
    analytic-signal matrix and fit (float64)."""
    crd = coords(CONFIG)
    host = host_fields(N_OBS, N_LAT, N_LON, SEED, 'cpu')
    A = mca.analytic_matrix(N_OBS, torch.float64, 'cpu')
    fields = [mca.Field(h, crd['lat'], torch.float64, 'cpu') for h in host]
    ref = mca.fit(fields, SOLVER_SEED, 'cpu', torch.float64, 'cpu',
                  k=N_ROT, n_iter=12, tol=1e-8, A=A)
    assert ref['converged']
    return crd, host, A, ref


@pytest.fixture(scope='module', params=['fft', 'fold'])
def model(request, inputs):
    """``(route, fitted model, its singular values before the
    rotation)``; the threshold stays patched while the tests use the
    model."""
    crd, host, _, _ = inputs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tarr, '_HILBERT_MATMUL_MAX_N', THRESHOLD[request.param])
        m = xMCA(*[DataArray(h, dims=('time', 'lat', 'lon'), coords=crd)
                   for h in host], device='cpu')
        m.set_solver(truncate=N_ROT, seed=SOLVER_SEED)
        m.normalize()
        m.apply_coslat()
        m.solve(complexify=True)
        svals = np.asarray(m.singular_values().values)
        m.rotate(N_ROT, power=1, tol=1e-8)
        yield request.param, m, svals


def test_the_solve_takes_its_route(model):
    route, m, _ = model
    # the fold leaves Z to its first consumer; the long route built it
    assert m._complexify_pending is (route == 'fold')


def test_the_rotated_fit_matches_the_reference(model, inputs):
    _, m, svals = model
    ref = inputs[3]
    assert rel(svals, ref['svals']) < SVALS_TOL
    assert rel(m._analysis['total_covariance'], ref['total']) < TOTAL_TOL
    var = np.asarray(m.variance().values)
    assert rel(var.sum(), ref['variance'].sum()) < ROT_TOTAL_TOL
    assert rel(var, ref['variance']) < VARIANCE_TOL


def test_two_rule_n_runs_match_the_reference(model, inputs):
    """The benchmark's check of a Rule-N run: +-1 surrogates, the 'fast'
    spectrum with 6 subspace rounds, jitter 2e-3, varimax to 1e-4."""
    _, m, _ = model
    _, _, A, ref = inputs
    out = np.asarray(m.rule_n(2, seed=RULE_N_SEED).values)
    assert out.shape == (N_ROT, 2)
    total = float(np.sum(ref['variance']))
    for r, s in enumerate(mca.run_seeds(RULE_N_SEED, 2)):
        want, conv = mca.rulen_run(s, N_OBS, (N_LAT * N_LON,) * 2,
                                   torch.float64, 'cpu', A, k=N_ROT,
                                   n_iter=6, tol=1e-4, jitter_rel=2e-3)
        assert conv
        got = out[:, r]
        assert rel(got / got.sum(), want / want.sum()) < RUN_GAP_TOL
        assert abs(got.sum() - total) / total < SCALE_GAP_TOL

"""Rule N on an unrotated complexified model, against the benchmark's
plain reference (``perfbench/reference/rulen_unrot.py``), on the CPU.

An unrotated run's spectrum is the top singular values of its reduced
kernel ``M``, rescaled by the model's total over the run's own, the
nuclear norm of ``M`` by 20 scaled Newton-Schulz steps (the 1e-4
schedule); the reference takes the exact nuclear norm.  The fields are
the benchmark's (``perfbench/fields.py``) on a 12 x 24 grid at 150 steps,
float32 as the deployment states; the pipeline is the benchmark's without
its rotation (``set_solver(truncate=10)``, ``normalize``,
``apply_coslat``, ``solve(complexify=True)``), on the analytic fold
('fold') and, with the threshold patched to 64, on the route of long
records ('fft'); the reference runs in float64 from the same seeds.

Tolerances (relative), each from the float32 arithmetic of the port;
the largest gaps over five seeds on both routes are in brackets:

* singular values 2e-5 [7.8e-6] and the exact total 2e-6 [3.5e-7], as
  the rotated model's (``test_torch_long_record.py``): f32 products over
  288 columns and a 150 x 150 Cholesky reduction;
* a run's spectrum over its sum 5e-6 [3.2e-7], and its rescaled sum
  5e-6 [2.9e-7]: the same f32 reduction of a +-1 run; the sum also holds
  the run's iterative total against the exact one, whose gap the schedule
  bounds at 1e-4 and which reads under 1.1e-7 here (next item);
* the Newton-Schulz nuclear norm of a seeded complex64 150 x 150 matrix
  against ``svdvals(...).sum()`` in complex128: 1e-4 on the surrogate
  schedule (its stopping tolerance) [1.1e-7], 1e-6 on the exact one
  (schedule 1e-8; f32 products over 150 terms) [7.4e-8].
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import xmca_tpu_torch.api.array as tarr
from perfbench.fields import coords, host_fields
from perfbench.reference import mca
from perfbench.reference.rulen_unrot import rulen_unrot_run
from xmca_tpu_torch.core import fastpath
from xmca_tpu_torch.utils import trace
from xmca_tpu_torch.xarray import DataArray, xMCA

N_OBS, N_LAT, N_LON, N_MODES, RUNS = 150, 12, 24, 10, 2
SEED, SOLVER_SEED, RULE_N_SEED = 2 ** 31 + 17, 17, 2 ** 31 + 22
CONFIG = dict(n_obs=N_OBS, n_lat=N_LAT, n_lon=N_LON, lat_range=[-90, 90],
              lon_range=[0, 359])
SVALS_TOL, TOTAL_TOL = 2e-5, 2e-6
RUN_GAP_TOL, SCALE_GAP_TOL = 5e-6, 5e-6
NS_TOL = {'surrogate': 1e-4, 'exact': 1e-6}
NS_STEPS = {'surrogate': 20, 'exact': 26}
# the threshold each route is reached at: below the record, or the port's
THRESHOLD = {'fft': 64, 'fold': tarr._HILBERT_MATMUL_MAX_N}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


@pytest.fixture(scope='module')
def inputs():
    """The host fields, the grid's coordinates and the reference's
    analytic-signal matrix and unrotated fit (float64)."""
    crd = coords(CONFIG)
    host = host_fields(N_OBS, N_LAT, N_LON, SEED, 'cpu')
    A = mca.analytic_matrix(N_OBS, torch.float64, 'cpu')
    fields = [mca.Field(h, crd['lat'], torch.float64, 'cpu') for h in host]
    ref = mca.fit(fields, SOLVER_SEED, 'cpu', torch.float64, 'cpu',
                  k=N_MODES, n_iter=12, tol=None, A=A, with_total=True)
    return crd, host, A, ref


def _fit(crd, host):
    m = xMCA(*[DataArray(h, dims=('time', 'lat', 'lon'), coords=crd)
               for h in host], device='cpu')
    m.set_solver(truncate=N_MODES, seed=SOLVER_SEED)
    m.normalize()
    m.apply_coslat()
    m.solve(complexify=True)
    return m


@pytest.fixture(scope='module', params=['fft', 'fold'])
def model(request, inputs):
    """``(route, unrotated model)``; the threshold stays patched while
    the tests use the model."""
    crd, host, _, _ = inputs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tarr, '_HILBERT_MATMUL_MAX_N', THRESHOLD[request.param])
        yield request.param, _fit(crd, host)


def _rule_n(m):
    return np.asarray(m.rule_n(RUNS, seed=RULE_N_SEED).values)


def _profiled(fn):
    """``fn()`` under a CPU-activity profile, from an empty buffer;
    returns its result and the spans it recorded."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.spans()


def test_the_solve_takes_its_route(model):
    route, m = model
    # the fold leaves Z to its first consumer; the long route built it
    assert m._complexify_pending is (route == 'fold')
    assert not m._analysis['is_rotated']


def test_the_unrotated_fit_matches_the_reference(model, inputs):
    _, m = model
    ref = inputs[3]
    assert rel(m.singular_values().values, ref['svals']) < SVALS_TOL
    assert rel(m._analysis['total_covariance'], ref['total']) < TOTAL_TOL


def test_unrotated_rule_n_runs_match_the_reference(model, inputs):
    """The benchmark's check of an unrotated run: +-1 surrogates, the
    'fast' spectrum with 6 subspace rounds, jitter 2e-3, the run's total
    by the surrogate schedule against the exact nuclear norm."""
    _, m = model
    _, _, A, ref = inputs
    out = _rule_n(m)
    assert out.shape == (N_MODES, RUNS)
    for r, s in enumerate(mca.run_seeds(RULE_N_SEED, RUNS)):
        vals, total = rulen_unrot_run(s, N_OBS, (N_LAT * N_LON,) * 2,
                                      torch.float64, 'cpu', A, k=N_MODES,
                                      n_iter=6, jitter_rel=2e-3)
        want = vals * (ref['total'] / total)
        got = out[:, r]
        assert rel(got / got.sum(), want / want.sum()) < RUN_GAP_TOL
        assert rel(got.sum(), want.sum()) < SCALE_GAP_TOL


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('schedule', ['surrogate', 'exact'])
def test_nuclear_norm_matches_the_singular_values(schedule, seed):
    gen = torch.Generator().manual_seed(seed)
    M = torch.complex(torch.randn((150, 150), generator=gen),
                      torch.randn((150, 150), generator=gen))
    norm = {'surrogate': fastpath.nuclear_norm_surrogate,
            'exact': fastpath.nuclear_norm}[schedule]
    want = float(torch.linalg.svdvals(M.to(torch.complex128)).sum())
    assert abs(float(norm(M)) - want) / want < NS_TOL[schedule]


def test_one_nuclear_span_a_run_under_a_profiler(model):
    """Each unrotated run takes its total in one ``nuclear`` span, a
    child of the run, on the surrogate schedule's 20 steps, and
    ``ns_steps`` counts them, with or without a profiler."""
    _, m = model
    trace.reset_counters('ns_steps')
    _, spans = _profiled(lambda: _rule_n(m))
    by_id = {s['id']: s for s in spans}
    runs = [s for s in spans if s['name'] == 'run']
    nuclear = [s for s in spans if s['name'] == 'nuclear']
    assert len(runs) == RUNS
    assert sorted(by_id[s['parent']]['id'] for s in nuclear) == sorted(
        r['id'] for r in runs)
    for s in nuclear:
        assert s['attrs'] == {'steps': NS_STEPS['surrogate'],
                              'schedule': 'surrogate'}
    assert trace.counts('ns_steps') == {'surrogate': RUNS * 20}
    _rule_n(m)
    assert trace.counts('ns_steps') == {'surrogate': 2 * RUNS * 20}


def test_the_solve_takes_its_total_in_one_exact_span(inputs):
    crd, host, _, _ = inputs
    trace.reset_counters('ns_steps')
    _, spans = _profiled(lambda: _fit(crd, host))
    nuclear = [s for s in spans if s['name'] == 'nuclear']
    assert [s['attrs'] for s in nuclear] == [{'steps': NS_STEPS['exact'],
                                              'schedule': 'exact'}]
    assert trace.counts('ns_steps') == {'exact': NS_STEPS['exact']}


def test_no_span_without_a_profiler_and_bit_equal_spectra(model):
    _, m = model
    trace.clear()
    plain = _rule_n(m)
    assert trace.spans() == []
    profiled, spans = _profiled(lambda: _rule_n(m))
    assert any(s['name'] == 'nuclear' for s in spans)
    np.testing.assert_array_equal(plain, profiled)

"""The SES sweep kernel (``ops/ses.py``, ``csrc/ses_sweep.cu``) against
its plain version (``core/theta.py:_ses_sweep``).

On the CPU: the wrapper refuses what the kernel does not take, grids
beyond a block among it, before it builds or launches anything, and ``_ses_fit`` takes the plain loop for a CPU tensor with no
kernel launch.  On the card
(marker ``cuda``; the tests skip without one): the kernel against the
plain loop run on the same card, at steps T in {1, 13, 480}, columns p
in {1, 37, 100003} (none a multiple of the 32-column block), the shared
33-point grid and the refined 17-point one, on constant, strictly
positive and signed columns: the same chosen indices, alpha bit for bit,
SSE and ``l_T`` within 1e-12 relative (the kernel rounds as the loop
does, so they agree to the bit); and the theta forecast on the card
against the benchmark's plain reference (``perfbench/reference/
theta.py``) within 1e-10 of each column's std.  No JAX here, so the
card's tests run where JAX is not installed:
``python -m pytest tests/unit/test_torch_ses.py -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.reference import theta as ref
from xmca_tpu_torch.core import theta as ttheta
from xmca_tpu_torch.ops import _build, ses
from xmca_tpu_torch.utils import trace

COARSE = np.linspace(0.02, 0.98, 33)
SPACING = (0.98 - 0.02) / 32
OFFSETS = np.linspace(-SPACING, SPACING, 17)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernel tests run on the card)')
    return torch.device('cuda')


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything builds or loads the kernel library."""
    def refuse():
        raise AssertionError('the kernel library was loaded')
    monkeypatch.setattr(_build, 'library', refuse)
    trace.reset_counters('launches')
    yield
    assert 'ses_sweep' not in trace.counts('launches')


def _field(kind, T, p, seed=0):
    """float32 (T, p): 'constant' columns (each its own value, signed),
    'positive' (persistent AR(1) 0.9 plus a seasonal cycle, shifted
    strictly positive) or 'signed' (the same, centered)."""
    rng = np.random.default_rng(seed)
    if kind == 'constant':
        return np.repeat(rng.uniform(-5, 5, (1, p)), T, axis=0).astype(
            np.float32)
    x = np.zeros((T, p))
    e = rng.standard_normal((T, p))
    for t in range(1, T):
        x[t] = 0.9 * x[t - 1] + e[t]
    x += 2 * np.sin(2 * np.pi * np.arange(T) / 12)[:, None] * (
        rng.standard_normal(p))
    x = x - x.mean(axis=0) if kind == 'signed' else x - x.min() + 1.0
    return x.astype(np.float32)


@pytest.mark.parametrize('case', ['cpu', 'half', 'int', 'empty_steps',
                                  'empty_columns', 'one_dim', 'unclipped'])
def test_ses_sweep_refuses_before_any_launch(case, no_build):
    y = {'cpu': torch.ones((4, 3)),
         'half': torch.ones((4, 3), dtype=torch.float16),
         'int': torch.ones((4, 3), dtype=torch.int32),
         'empty_steps': torch.ones((0, 3)),
         'empty_columns': torch.ones((4, 0)),
         'one_dim': torch.ones(4),
         'unclipped': torch.ones((4, 3))}[case]
    refined = (torch.zeros(3, dtype=torch.int64), torch.as_tensor(OFFSETS))
    with pytest.raises(ValueError, match='ses_sweep'):
        ses.ses_sweep(y, torch.as_tensor(COARSE),
                      *(refined if case == 'unclipped' else ()))


@pytest.mark.parametrize('G', [0, 1, 17, 33, 48, 49, 64, 89])
def test_ses_sweep_takes_grids_of_one_block(G, no_build):
    """A block holds 1 to ``MAX_GRID`` grid points: any other grid is
    refused before the device is looked at, the others on the CPU
    only for the device."""
    alphas = torch.linspace(0.1, 0.9, G, dtype=torch.float64)
    match = 'grid points' if not 1 <= G <= ses.MAX_GRID else 'CUDA device'
    with pytest.raises(ValueError, match=match):
        ses.ses_sweep(torch.ones((4, 3)), alphas)


def test_ses_fit_takes_the_plain_loop_on_the_cpu(no_build):
    y = torch.as_tensor(_field('signed', 40, 9))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        alpha, level = ttheta._ses_fit(y)
    spans = [s for s in trace.spans() if s['name'] == 'ses']
    assert [s['attrs'] for s in spans] == [
        {'steps': 40, 'grid': g, 'columns': 9, 'route': 'plain'}
        for g in (33, 17)]
    assert alpha.dtype == level.dtype == torch.float32
    want = ttheta._ses_fit_plain(y, torch.as_tensor(COARSE),
                                 torch.as_tensor(OFFSETS))
    assert torch.equal(alpha, want[0].float())
    assert torch.equal(level, want[1].float())


# ------------------------------------------------------------- on the card
def _plain_states(y64, grid):
    sse, level = ttheta._ses_sweep(y64, grid)
    return sse, level, torch.argmin(sse, dim=0)


def _agree(got, grid, sse, level, best):
    """The kernel's (best, alpha, level, sse, l_T) against the plain
    sweep's states on ``grid`` (G,) or (G, p)."""
    k_best, k_alpha, k_level, k_sse, k_lT = got
    assert torch.equal(k_best, best)
    g = grid[:, None].expand_as(sse) if grid.dim() == 1 else grid
    assert torch.equal(k_alpha, g.gather(0, best[None])[0])
    assert torch.equal(k_level, level.gather(0, best[None])[0])
    torch.testing.assert_close(k_sse, sse, rtol=1e-12, atol=0)
    torch.testing.assert_close(k_lT, level, rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['constant', 'positive', 'signed'])
@pytest.mark.parametrize('p', [1, 37, 100003])
@pytest.mark.parametrize('T', [1, 13, 480])
def test_ses_sweep_kernel_matches_plain(cuda_device, T, p, kind):
    y = torch.as_tensor(_field(kind, T, p, seed=T + p), device=cuda_device)
    y64 = y.double()
    coarse = torch.as_tensor(COARSE, device=cuda_device)
    offsets = torch.as_tensor(OFFSETS, device=cuda_device)
    sse, level, best = _plain_states(y64, coarse)
    _agree(ses.ses_sweep(y, coarse, states=True), coarse, sse, level, best)
    clip = ttheta.ALPHA_CLIP
    fine = torch.clamp(coarse[best][None, :] + offsets[:, None], *clip)
    sse_f, level_f, best_f = _plain_states(y64, fine)
    _agree(ses.ses_sweep(y, coarse, best, offsets, clip, states=True), fine,
           sse_f, level_f, best_f)
    # the float64 series gives the same bits
    again = ses.ses_sweep(y64, coarse, best, offsets, clip, states=True)
    _agree(again, fine, sse_f, level_f, best_f)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64,
                                   torch.float16])
def test_ses_fit_kernel_matches_plain_fit(cuda_device, dtype):
    """Two launches, two ``ses`` spans with route 'kernel', and the plain
    fit's alpha and ``l_T`` bit for bit."""
    y = torch.as_tensor(_field('positive', 120, 4099, seed=5),
                        device=cuda_device).to(dtype)
    trace.reset_counters('launches')
    trace.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        alpha, level = ttheta._ses_fit(y)
    torch.cuda.synchronize()
    assert trace.counts('launches') == {'ses_sweep': 2}
    assert [s['attrs'] for s in trace.spans() if s['name'] == 'ses'] == [
        {'steps': 120, 'grid': g, 'columns': 4099, 'route': 'kernel'}
        for g in (33, 17)]
    want = ttheta._ses_fit_plain(y, torch.as_tensor(COARSE, device=y.device),
                                 torch.as_tensor(OFFSETS, device=y.device))
    assert alpha.dtype == level.dtype == dtype
    assert torch.equal(alpha, want[0].to(dtype))
    assert torch.equal(level, want[1].to(dtype))


@pytest.mark.cuda
def test_ses_sweep_kernel_refuses_what_it_cannot_take(cuda_device):
    y = torch.ones((8, 64), device=cuda_device)
    coarse = torch.as_tensor(COARSE, device=cuda_device)
    offsets = torch.as_tensor(OFFSETS, device=cuda_device)
    best = torch.zeros(64, dtype=torch.int64, device=cuda_device)
    clip = ttheta.ALPHA_CLIP
    for args in [(y[:, ::2], coarse), (y, coarse, best),
                 (y, coarse, best, offsets), (y, coarse.float()),
                 (y, coarse, best.int(), offsets, clip),
                 (y, coarse, best[:10], offsets, clip), (y, coarse.cpu()),
                 (y, torch.linspace(0.1, 0.9, 89, dtype=torch.float64,
                                    device=cuda_device))]:
        with pytest.raises(ValueError):
            ses.ses_sweep(*args)


@pytest.mark.cuda
@pytest.mark.parametrize('period', [1, 12])
@pytest.mark.parametrize('T', [48, 120])
def test_theta_forecast_on_the_card_matches_reference(cuda_device, T,
                                                      period):
    """The float64 forecast through the kernel against the benchmark's
    plain reference (on the CPU), within 1e-10 of each column's std."""
    y = torch.as_tensor(_field('signed', T, 32, seed=T + period),
                        dtype=torch.float64)
    y[:, :10] += 20.0
    got = ttheta.theta_forecast(y.to(cuda_device), T, period).cpu()
    want = ref.theta_forecast(y, T, period)
    dev = (got - want).abs().amax(dim=0) / y.std(dim=0)
    assert float(dev.max()) < 1e-10

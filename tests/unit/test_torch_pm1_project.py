"""The +-1 back-projection kernel (``ops/project.py``,
``csrc/pm1_project.cu``) against its plain version
(``core/fastpath.py:_pm1_project_plain``) and an f64 product.

On the CPU: the wrapper refuses what the kernel does not take (dtype,
shape, device, contiguity) before it builds or launches anything, the
launches cover any width of S once, and ``_pm1_project`` takes the
plain blocked cast for a CPU field with no kernel launch.  On the card
(marker ``cuda``; the tests skip without one): the kernel against
``X.double().T @ S_pad.double()`` within ``PROJECT_TOL`` and against
the plain version run on the same card, at n_pad in {128, 2048, 14720},
widths whose last block of columns is ragged (p below the padded width,
zero pad columns) and m in {1, 10, 20, 33}; and ``rule_n(2)`` of a small
rotated complexified model through the kernel, two launches a run,
against the same runs through the plain version.  No JAX here, so the
card's tests run where JAX is not installed:
``python -m pytest tests/unit/test_torch_pm1_project.py -m cuda
--noconftest``.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xmca_tpu_torch.core import fastpath as fp
from xmca_tpu_torch.ops import _build, project
from xmca_tpu_torch.ops.syrk import pad_to
from xmca_tpu_torch.utils import trace

# a back-projection against an f64 product, rel Frobenius: f32 sums of
# +-1 terms, summed in chunks of 128 rows (chip_smoke.py's PROJECT_TOL)
PROJECT_TOL = 1e-6
# two rotations of loadings a roundoff apart may stop a varimax step
# apart (chip_smoke.py's ROT_STOP_TOL)
ROT_STOP_TOL = 1e-2


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
    assert 'pm1_project' not in trace.counts('launches')


def _field(n, p, n_pad, p_pad, seed, device='cpu'):
    """Padded int8 field: +-1 where r < n and c < p, 0 elsewhere."""
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.zeros((n_pad, p_pad), dtype=torch.int8, device=device)
    X[:n, :p] = torch.randint(0, 2, (n, p), generator=gen, device=device,
                              dtype=torch.int8) * 2 - 1
    return X


def _weights(n, n_pad, m, seed, device='cpu'):
    """f32 S_pad (n_pad, m): normal rows below n, zero rows after."""
    gen = torch.Generator(device=device).manual_seed(seed)
    S = torch.zeros((n_pad, m), device=device)
    S[:n] = torch.randn((n, m), generator=gen, device=device)
    return S


@pytest.mark.parametrize('case', [
    'cpu', 'int16', 'float', 'one_dim', 'weights_f64', 'weights_rows',
    'weights_one_dim', 'weights_empty', 'no_columns', 'too_many_columns',
    'odd_width', 'width_of_words', 'field_strided', 'weights_strided'])
def test_pm1_project_refuses_before_any_launch(case, no_build):
    X = torch.ones((8, 16), dtype=torch.int8)
    S = torch.ones((8, 3))
    p = 12
    if case == 'int16':
        X = X.to(torch.int16)
    elif case == 'float':
        X = X.float()
    elif case == 'one_dim':
        X = X.reshape(-1)
    elif case == 'weights_f64':
        S = S.double()
    elif case == 'weights_rows':
        S = torch.ones((7, 3))
    elif case == 'weights_one_dim':
        S = torch.ones(8)
    elif case == 'weights_empty':
        S = torch.ones((8, 0))
    elif case == 'no_columns':
        p = 0
    elif case == 'too_many_columns':
        p = 17
    elif case == 'odd_width':
        X, p = torch.ones((8, 14), dtype=torch.int8), 14
    elif case == 'width_of_words':
        X, p = torch.ones((8, 20), dtype=torch.int8), 20
    elif case == 'field_strided':
        X = torch.ones((8, 64), dtype=torch.int8)[:, ::4]
    elif case == 'weights_strided':
        S = torch.ones((3, 8)).T
    match = 'CUDA device' if case == 'cpu' else 'pm1_project'
    with pytest.raises(ValueError, match=match):
        project.pm1_project(X, S, p)


@pytest.mark.parametrize('m', [1, 9, 10, 11, 19, 20, 21, 30, 33, 40, 61])
def test_passes_cover_every_column_once(m):
    """Tiles of 20 columns while more than 10 remain, the last one 10 or
    20 wide: each column of S in exactly one launch, one launch at the
    main paths' m = 20 and m = 10."""
    tiles = project.passes(m)
    assert all(w in (project.WIDE, project.NARROW) for _, w in tiles)
    assert [j0 for j0, _ in tiles] == list(np.cumsum(
        [0] + [w for _, w in tiles[:-1]]))
    covered = [j for j0, w in tiles for j in range(j0, min(j0 + w, m))]
    assert covered == list(range(m))
    assert tiles[-1][0] + tiles[-1][1] - m < project.NARROW
    assert (len(tiles) == 1) == (m <= project.WIDE)


@pytest.mark.parametrize('cols', [None, 96])
def test_pm1_project_takes_the_plain_path_on_the_cpu(cols, no_build,
                                                    monkeypatch):
    """A CPU field: one ``project`` span, the plain blocked cast (its
    blocks counted, ``cols`` columns each or one block) bit for bit, no
    kernel launch."""
    n, p = 100, 300
    n_pad, p_pad = pad_to(n, p)
    X = _field(n, p, n_pad, p_pad, seed=1)
    S = _weights(n, n, 20, seed=2)
    if cols is not None:
        monkeypatch.setattr(fp, '_PROJECT_BYTES', 4 * n_pad * cols)
    blocks = []
    inner = fp._pm1_blocks

    def counted(X_, stop):
        for c0, block in inner(X_, stop):
            blocks.append(block.shape[1])
            yield c0, block
    monkeypatch.setattr(fp, '_pm1_blocks', counted)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = fp._pm1_project(X, S, p)
    assert [s['name'] for s in trace.spans()] == ['project']
    assert blocks == ([p_pad] if cols is None else
                      [min(cols, p_pad - c) for c in range(0, p, cols)])
    S_pad = torch.zeros((n_pad, 20))
    S_pad[:n] = S
    assert torch.equal(got, fp._pm1_project_plain(X, S_pad, p))
    exact = (X.double().T @ S_pad.double())[:p]
    assert float(torch.linalg.norm(got.double() - exact)
                 / torch.linalg.norm(exact)) <= PROJECT_TOL


# ------------------------------------------------------------- on the card
def _rel(got, ref):
    got, ref = got.double(), ref.double()
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 10, 20, 33])
@pytest.mark.parametrize('p', [1, 517, 100000])
@pytest.mark.parametrize('n', [100, 2000, 14610])
def test_pm1_project_kernel_matches_float64(cuda_device, n, p, m):
    """The kernel within PROJECT_TOL of the f64 product of the same
    field and weights, the same bits on a second launch, and against the
    plain blocked version on the card: within PROJECT_TOL beyond the
    plain version's own distance from f64 (a single f32 sum over n_pad
    rows, which drifts with n_pad).  p = 517 and 100000 end in a ragged
    block of columns with zero pad columns after them."""
    n_pad, p_pad = pad_to(n, p)
    X = _field(n, p, n_pad, p_pad, seed=n + p, device=cuda_device)
    S_pad = _weights(n, n_pad, m, seed=m, device=cuda_device)
    trace.reset_counters('launches')
    got = project.pm1_project(X, S_pad, p)
    again = project.pm1_project(X, S_pad, p)
    assert trace.counts('launches') == {
        'pm1_project': 2 * len(project.passes(m))}
    exact = (X.double().T @ S_pad.double())[:p]
    plain = fp._pm1_project_plain(X, S_pad, p)
    torch.cuda.synchronize()
    assert got.shape == (p, m) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert _rel(got, exact) <= PROJECT_TOL
    assert _rel(got, plain) <= PROJECT_TOL + _rel(plain, exact)


@pytest.mark.cuda
def test_pm1_project_kernel_reads_every_row_of_the_field(cuda_device):
    """Nonzero pad rows and pad columns: the kernel is X^T S_pad over
    every row of the field and drops columns >= p, as the plain version
    does."""
    n_pad, p_pad, p, m = 256, 1024, 700, 20
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    X = torch.randint(-1, 2, (n_pad, p_pad), generator=gen,
                      device=cuda_device).to(torch.int8)
    S_pad = torch.randn((n_pad, m), generator=gen, device=cuda_device)
    got = project.pm1_project(X, S_pad, p)
    exact = (X.double().T @ S_pad.double())[:p]
    assert _rel(got, exact) <= PROJECT_TOL


@pytest.mark.cuda
def test_pm1_project_kernel_refuses_what_it_cannot_take(cuda_device):
    X = torch.ones((128, 256), dtype=torch.int8, device=cuda_device)
    S = torch.ones((128, 20), device=cuda_device)
    for args in [(X[:, ::2], S, 64), (X, S[:, ::2], 64), (X, S.cpu(), 64),
                 (X, S.double(), 64), (X.float(), S, 64), (X, S[:64], 64),
                 (X, S, 257), (X[:, 1:], S, 64),
                 (X.reshape(-1)[4:4 + 128 * 128].reshape(128, 128), S, 64)]:
        with pytest.raises(ValueError, match='pm1_project'):
            project.pm1_project(*args)


@pytest.mark.cuda
def test_rule_n_projects_through_the_kernel(cuda_device, monkeypatch):
    """``rule_n(2)`` of a small rotated complexified model: each run
    projects its two fields with one launch each (m = 20), and the null
    equals that of the same runs through the plain blocked version on
    the card within ROT_STOP_TOL."""
    from xmca_tpu_torch.array import MCA
    rng = np.random.default_rng(5)
    t = np.arange(300, dtype=np.float32)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 5) / 300)
    fields = [(modes @ rng.standard_normal((4, p))
               + rng.standard_normal((300, p))).astype(np.float32)
              for p in (700, 520)]
    model = MCA(*fields, device=cuda_device)
    model.set_solver(truncate=6)
    model.solve(complexify=True)
    model.rotate(6)
    trace.reset_counters('launches')
    null = model.rule_n(2, seed=11)
    assert trace.counts('launches').get('pm1_project') == 2 * 2
    monkeypatch.setattr(fp, 'pm1_project', fp._pm1_project_plain)
    trace.reset_counters('launches')
    plain = model.rule_n(2, seed=11)
    assert 'pm1_project' not in trace.counts('launches')
    null, plain = np.asarray(null), np.asarray(plain)
    assert null.shape == plain.shape and null.shape[0] == 6
    assert null.shape[1] >= 1 and np.isfinite(null).all()
    assert float(np.abs(null / plain - 1).max()) <= ROT_STOP_TOL

"""The port's Rule-N surrogate tail against the JAX package on the SAME
+-1 fields.

The JAX pipeline (``fast_surrogate_variance_tri``, run un-jitted through
``__wrapped__``) draws its fields through ``xmca_tpu.ops.surrogate
.bits_field``; the test replaces that function with one that returns
numpy-seeded fields, and hands the same fields to the port through its
``fields=`` argument, with the JAX start block as ``omega``.  The JAX
side's syrk runs in Pallas interpret mode.  Both sides run at the JAX
function's own f32/c64 dtypes, so the tolerance is f32-sized: the
Gram is integer-exact on both sides, and the remaining difference is
f32 roundoff through Cholesky, the subspace iteration and the rotation
fixed point (mode space adds ~1e-3, see rotation.ensemble_space).

The rotated tails run again with the port's back-projection budget
(``core.fastpath._PROJECT_BYTES``) patched so that each field is cast
to f32 in ragged column blocks; ``_pm1_project`` itself is held against
a float64 product for one, two, ragged and one-column blocks.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xmca_tpu.ops.surrogate as jsur
from xmca_tpu.core import fastpath as jfast
from xmca_tpu_torch.core import fastpath as tfast
from xmca_tpu_torch.core.rotation import ensemble_space
from xmca_tpu_torch.ops.syrk import pad_to

N_OBS = 64
N_VARS = (300, 260)
SEED = 5
TOL_VAR = 2e-3       # f32 tail, mode-space iterate noise ~1e-3


def _fields(seed):
    rng = np.random.default_rng(seed)
    return [rng.choice(np.array([-1, 1], np.int8), size=(N_OBS, p))
            for p in N_VARS]


def _block_budget(monkeypatch, cols):
    """Patch the back-projection budget to ``cols`` columns a block of a
    field padded to N_OBS's rows; count the projections it serves."""
    monkeypatch.setattr(tfast, '_PROJECT_BYTES',
                        4 * pad_to(N_OBS, 1)[0] * cols)
    projected = []
    inner = tfast._pm1_project

    def counted(X, S, p):
        projected.append(p)
        return inner(X, S, p)
    monkeypatch.setattr(tfast, '_pm1_project', counted)
    return projected


def _run_both(monkeypatch, *, complexify, rotated, n_rot, grade):
    fields = _fields(11)
    calls = []

    def fake_bits_field(fseed, shape, dist='rademacher8', impl='rbg'):
        X = np.zeros(shape, np.int8)
        f = fields[len(calls)]
        calls.append(int(fseed))
        X[:f.shape[0], :f.shape[1]] = f
        return jnp.asarray(X)

    monkeypatch.setattr(jsur, 'bits_field', fake_bits_field)
    H = jfast.hilbert_imag_matrix(N_OBS, np.float32)
    key = jax.random.PRNGKey(SEED)
    kk = min(n_rot + 16, N_OBS)
    cdtype = jnp.complex64 if complexify else jnp.float32
    omega = np.array(jax.random.normal(key, (N_OBS, kk), jnp.float32)
                       .astype(cdtype))
    common = dict(complexify=complexify, rotated=rotated, n_rot=n_rot,
                  power=1, tol=1e-4, n_iter=6, polar_method='ns14',
                  grade=grade)
    var_j, tot_j, conv_j = jfast.fast_surrogate_variance_tri.__wrapped__(
        SEED, key, N_OBS, N_VARS, H=jnp.asarray(H) if complexify else None,
        dist='rademacher8', **common)
    assert calls == [2 * SEED, 2 * SEED + 1]

    padded = []
    for f, p in zip(fields, N_VARS):
        X = torch.zeros(pad_to(N_OBS, p), dtype=torch.int8)
        X[:N_OBS, :p] = torch.from_numpy(f)
        padded.append(X)
    var_t, tot_t, conv_t, _ = tfast.fast_surrogate_variance_tri(
        SEED, torch.from_numpy(omega), N_OBS, N_VARS,
        H=torch.tensor(H) if complexify else None, fields=padded,
        **common)
    assert bool(conv_j) and conv_t
    return (np.asarray(var_j), float(tot_j)), (var_t.numpy(), float(tot_t))


def _complex_tail(monkeypatch, grade, n_rot, space):
    assert ensemble_space(sum(N_VARS), n_rot, 8) == space
    (var_j, tot_j), (var_t, tot_t) = _run_both(
        monkeypatch, complexify=True, rotated=True, n_rot=n_rot,
        grade=grade)
    assert var_t.dtype == np.float32 and var_t.shape == (n_rot,)
    np.testing.assert_allclose(var_t, var_j, rtol=TOL_VAR)
    np.testing.assert_allclose(tot_t, tot_j, rtol=TOL_VAR)


def _real_tail(monkeypatch):
    (var_j, tot_j), (var_t, tot_t) = _run_both(
        monkeypatch, complexify=False, rotated=True, n_rot=4,
        grade='fast')
    np.testing.assert_allclose(var_t, var_j, rtol=TOL_VAR)


@pytest.mark.parametrize('grade', ['exact', 'fast'])
@pytest.mark.parametrize('n_rot, space', [(4, 'mode'), (6, 'data')])
def test_rotated_complex_tail_matches_jax(monkeypatch, grade, n_rot, space):
    _complex_tail(monkeypatch, grade, n_rot, space)


def test_rotated_real_tail_matches_jax(monkeypatch):
    _real_tail(monkeypatch)


# columns a block: 100 cuts both fields raggedly (300 = 3 x 100; 260 in
# three, the last 60 columns and 40 of pad), 1 casts a column at a time
@pytest.mark.parametrize('cols', [100, 1])
@pytest.mark.parametrize('grade', ['exact', 'fast'])
@pytest.mark.parametrize('n_rot, space', [(4, 'mode'), (6, 'data')])
def test_rotated_complex_tail_blocked_matches_jax(monkeypatch, grade, n_rot,
                                                  space, cols):
    """The complex tail with the fields cast in column blocks."""
    projected = _block_budget(monkeypatch, cols)
    _complex_tail(monkeypatch, grade, n_rot, space)
    assert projected == list(N_VARS)


@pytest.mark.parametrize('cols', [100, 1])
def test_rotated_real_tail_blocked_matches_jax(monkeypatch, cols):
    """The real tail with the fields cast in column blocks."""
    projected = _block_budget(monkeypatch, cols)
    _real_tail(monkeypatch)
    assert projected == list(N_VARS)


@pytest.mark.parametrize('cols, blocks', [(None, (1, 1)), (192, (2, 2)),
                                          (128, (3, 3)), (100, (3, 3)),
                                          (1, N_VARS)])
def test_pm1_project_blocks_match_float64(monkeypatch, cols, blocks):
    """``_pm1_project`` of injected padded +-1 fields against
    ``X.double().T @ S.double()`` within 1e-6 of the largest entry, for
    one block (the default budget: bit-equal to the whole-field f32
    product), two, three (ragged at 100: 300 columns in 3 x 100, 260 in
    100 + 100 + 60 and 40 columns of pad) and one column a block."""
    if cols is not None:
        monkeypatch.setattr(tfast, '_PROJECT_BYTES',
                            4 * pad_to(N_OBS, 1)[0] * cols)
    seen = []
    inner = tfast._pm1_blocks

    def counted(X, stop):
        for c0, block in inner(X, stop):
            seen.append(block.shape[1])
            yield c0, block
    monkeypatch.setattr(tfast, '_pm1_blocks', counted)
    rng = np.random.default_rng(17)
    S = torch.from_numpy(rng.standard_normal((N_OBS, 20)).astype(np.float32))
    for f, p, n_blocks in zip(_fields(11), N_VARS, blocks):
        X = torch.zeros(pad_to(N_OBS, p), dtype=torch.int8)
        X[:N_OBS, :p] = torch.from_numpy(f)
        del seen[:]
        got = tfast._pm1_project(X, S, p)
        assert got.dtype == torch.float32 and got.shape == (p, 20)
        assert len(seen) == n_blocks and sum(seen) >= p
        ref = (X[:N_OBS].double().T @ S.double())[:p].numpy()
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())
        if cols is None:
            S_pad = torch.zeros((X.shape[0], 20))
            S_pad[:N_OBS] = S
            whole = (S_pad.T @ X.to(torch.float32)).T[:p]
            assert torch.equal(got, whole)


def test_unrotated_complex_spectrum_matches_jax(monkeypatch):
    """Unrotated: the leading singular values and the NS nuclear-norm
    total (f32 Cholesky + subspace iteration: 1e-4)."""
    (s_j, tot_j), (s_t, tot_t) = _run_both(
        monkeypatch, complexify=True, rotated=False, n_rot=4,
        grade='exact')
    np.testing.assert_allclose(s_t, s_j, rtol=1e-4)
    np.testing.assert_allclose(tot_t, tot_j, rtol=1e-4)


def test_injected_fields_must_be_padded():
    bad = [torch.zeros((N_OBS, p), dtype=torch.int8) for p in N_VARS]
    omega = torch.zeros((N_OBS, 20))
    with pytest.raises(ValueError):
        tfast.fast_surrogate_variance_tri(
            SEED, omega, N_OBS, N_VARS, fields=bad)

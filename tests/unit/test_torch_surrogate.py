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


@pytest.mark.parametrize('grade', ['exact', 'fast'])
@pytest.mark.parametrize('n_rot, space', [(4, 'mode'), (6, 'data')])
def test_rotated_complex_tail_matches_jax(monkeypatch, grade, n_rot, space):
    assert ensemble_space(sum(N_VARS), n_rot, 8) == space
    (var_j, tot_j), (var_t, tot_t) = _run_both(
        monkeypatch, complexify=True, rotated=True, n_rot=n_rot,
        grade=grade)
    assert var_t.dtype == np.float32 and var_t.shape == (n_rot,)
    np.testing.assert_allclose(var_t, var_j, rtol=TOL_VAR)
    np.testing.assert_allclose(tot_t, tot_j, rtol=TOL_VAR)


def test_rotated_real_tail_matches_jax(monkeypatch):
    (var_j, tot_j), (var_t, tot_t) = _run_both(
        monkeypatch, complexify=False, rotated=True, n_rot=4,
        grade='fast')
    np.testing.assert_allclose(var_t, var_j, rtol=TOL_VAR)


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

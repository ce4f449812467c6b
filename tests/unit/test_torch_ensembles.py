"""The port's Rule-N ensembles against the JAX package on CPU.

* ``ops.surrogate.bits_to_draw`` against JAX's ``_bits_to_draw`` on the
  same 32-bit words, bit for bit, for every generated distribution; and
  'rademacher1', which is no field-kernel distribution in either package:
  the port routes it to the +-1 triangle-Gram pipeline, where it is the
  same draw as 'rademacher8'.
* ``stats.significance._surrogate_variance`` on injected fields (float64
  and bf16 Gaussian draws, and the bf16 fields of 'normal16', 'normal32'
  and 'rademacher') against JAX's, fast and exact, rotated and not, real
  and complexified, with JAX's start block injected.  bf16 fields are
  centered with an f32 mean and contracted with f32 accumulation in both
  packages; f32 roundoff then separates them (tolerances below).
* ``core.fastpath.fast_surrogate_variance_tri`` on injected padded +-1
  fields, its centering taken from the Gram, against the same tail fed
  the Gram of the explicitly centered field.
* ``MCA.rule_n``'s resolved configuration against the keyword arguments
  the JAX package's ``rule_n`` passes to ``rule_n_spectra`` (captured by
  a stand-in), with ``jax.default_backend`` patched to 'tpu' (every
  setting) and 'cpu' (settings that pin every backend-dependent key).
* The 'draw' source's seed plumbing, ``rule_n`` under
  ``spectrum='exact'``, and the ``ValueError`` cases.
"""
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from xmca_tpu.array import MCA as JMCA
from xmca_tpu.core import fastpath as jfast
from xmca_tpu.ops import surrogate as jsur
from xmca_tpu.stats import significance as jsig
from xmca_tpu_torch.array import MCA as TMCA
from xmca_tpu_torch.core import fastpath as tfast
from xmca_tpu_torch.ops import surrogate as tsur
from xmca_tpu_torch.stats import significance as tsig
from xmca_tpu_torch.utils.state import install_state, to_state

N, P_L, P_R, K = 48, 150, 130, 4
# float64: roundoff through the same algebra
RTOL_F64 = 1e-8
# bf16 fields: both packages run the n x n algebra in f32 from f32-exact
# products; f32 roundoff, and a rotation stopped at the f32 floor
# (measured up to 6.5e-5 on the real rotated case)
RTOL_BF16 = 2e-4
GEN_DISTS = ('normal32', 'normal16', 'rademacher', 'rademacher8')


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=shape,
                                                dtype=np.uint32)


# ------------------------------------------------------------ draw maps
@pytest.mark.parametrize('dist', GEN_DISTS)
def test_bits_to_draw_matches_jax(dist):
    words = _words((64, 96))
    ref = jsur._bits_to_draw(jnp.asarray(words), dist)
    got = tsur.bits_to_draw(_t(words.astype(np.int64)), dist)
    expect = torch.int8 if dist == 'rademacher8' else torch.bfloat16
    assert got.dtype == expect and str(ref.dtype) == str(expect)[6:]
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_rademacher1_is_routed_to_the_pm1_pipeline(monkeypatch):
    """Neither package maps 'rademacher1' words to values (JAX expands
    its bits in ``bits_field``); the port's Rule-N runs it on the +-1
    pipeline, bit for bit as 'rademacher8', and never calls the field
    kernel, which 'normal16' calls once a field a run."""
    words = jnp.asarray(_words((4, 8)))
    with pytest.raises(ValueError, match='rademacher1'):
        jsur._bits_to_draw(words, 'rademacher1')
    with pytest.raises(ValueError, match='rademacher1'):
        tsur.bits_to_draw(_t(np.asarray(words).astype(np.int64)),
                          'rademacher1')
    calls = []
    field = tsur.surrogate_field

    def spy(*args, **kw):
        calls.append(args)
        return field(*args, **kw)
    monkeypatch.setattr(tsur, 'surrogate_field', spy)
    kw = dict(complexify=True, rotated=True, n_rot=3, power=1, tol=1e-4,
              seed=5, n_modes_fast=3, subspace_iters=6, polar_method='ns14',
              device='cpu', H=tfast.hilbert_operator(N, torch.float32))
    out = {d: tsig.rule_n_generated(N, (P_L, P_R), 3, dist=d, **kw)
           for d in ('rademacher1', 'rademacher8')}
    assert calls == []
    for a, b in zip(out['rademacher1'][:2], out['rademacher8'][:2]):
        np.testing.assert_array_equal(a, b)
    spectra, totals, iters = tsig.rule_n_generated(N, (P_L, P_R), 3,
                                                   dist='normal16', **kw)
    assert len(calls) == 2 * 3 and iters is None
    assert spectra.shape == (3, 3) and np.isfinite(spectra).all()


# ------------------------------------------------- one surrogate's solve
def _fields(source):
    """Two (N, p) surrogate fields as numpy (float64 or float32 holding
    bf16 values) and the dtype both packages take them in."""
    if source == 'gauss64':
        rng = np.random.default_rng(0)
        return [rng.standard_normal((N, p)) for p in (P_L, P_R)], None
    if source == 'gauss16':
        rng = np.random.default_rng(1)
        fs = [torch.from_numpy(rng.standard_normal((N, p))).to(
            torch.bfloat16) for p in (P_L, P_R)]
    else:
        fs = [tsur.surrogate_field(11 + i, N, p, source, 'cpu')
              for i, p in enumerate((P_L, P_R))]
    return [f.to(torch.float32).numpy() for f in fs], 'bfloat16'


def _omega(key, k, dtype):
    return np.asarray(jax.random.normal(key, (N, min(k + 16, N)), dtype))


@pytest.mark.parametrize('source', ['gauss64', 'gauss16', 'normal16',
                                    'normal32', 'rademacher'])
@pytest.mark.parametrize('spectrum', ['fast', 'exact'])
@pytest.mark.parametrize('cplx', [False, True])
@pytest.mark.parametrize('rotated', [False, True])
def test_surrogate_variance_matches_jax(source, spectrum, cplx, rotated):
    """One Rule-N run's solve on injected fields, with the Rule-N polar
    of each source ('ns' for draws, 'ns14' for generated fields).  JAX
    has no bf16 dense decomposition (XLA refuses bf16 eigh), so for a
    real bf16 field under the exact spectrum the port, which upcasts, is
    held against its own solve of the f32 copy of the centered field."""
    arrays, half = _fields(source)
    f64 = half is None
    real = np.float64 if f64 else np.float32
    H = jfast.hilbert_imag_matrix(N, real)
    key = jax.random.PRNGKey(7)
    polar = 'ns' if source.startswith('gauss') else 'ns14'
    kw = dict(spectrum=spectrum, n_modes_fast=K, subspace_iters=12,
              polar_method=polar)
    use_h = spectrum == 'fast' and cplx
    args = (cplx, rotated, K, 1, 1e-8, 'gram')
    tf = [_t(a) if f64 else _t(a).to(torch.bfloat16) for a in arrays]
    omega = None
    if spectrum == 'fast':
        omega = _t(_omega(key, K, real))
        if cplx:
            omega = omega.to(torch.complex128 if f64 else torch.complex64)
    var_t, tot_t, conv_t = tsig._surrogate_variance(
        tf, *args, omega=omega, hilbert_H=_t(H) if use_h else None, **kw)
    jf = [jnp.asarray(a) if f64 else jnp.asarray(a).astype(jnp.bfloat16)
          for a in arrays]
    if not f64 and spectrum == 'exact' and not cplx:
        with pytest.raises(NotImplementedError, match='bfloat16'):
            jsig._surrogate_variance(jf, *args, fast_key=key, **kw)
        centered = [f - f.mean(dim=0, dtype=torch.float32).to(f.dtype)
                    for f in tf]
        var_j, tot_j, conv_j = tsig._surrogate_variance(
            [f.to(torch.float32) for f in centered], *args, **kw)
        # that solve centers the f32 copy once more: f32 roundoff, which
        # moves an f32 rotation's stopping point as in the JAX comparison
        rtol = RTOL_BF16
    else:
        var_j, tot_j, conv_j = jsig._surrogate_variance(
            jf, *args, fast_key=key,
            hilbert_H=jnp.asarray(H) if use_h else None, **kw)
        rtol = RTOL_F64 if f64 else RTOL_BF16
    assert conv_t is True and bool(conv_j)
    var_j = np.asarray(var_j, dtype=np.float64)
    assert var_t.shape == var_j.shape
    assert var_t.dtype == (torch.float64 if f64 else torch.float32)
    np.testing.assert_allclose(var_t.double().numpy()[:K], var_j[:K],
                               rtol=rtol)
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=rtol)


# ------------------------------------------------- +-1 Gram centering
@pytest.mark.parametrize('cplx', [False, True])
@pytest.mark.parametrize('rotated', [False, True])
def test_tri_centering_matches_centered_field(cplx, rotated):
    """The triangle-Gram pipeline centers its +-1 fields from the raw
    Gram alone (``w = G 1 / n``).  Its reference forms the float32 Gram
    of each field explicitly centered, passes it through the same fold
    and jitter and runs the same tail (``_surrogate_spectrum``, the same
    start block, ``_pm1_project`` with the column means), so only the
    centering differs: f32 roundoff, 1e-4 with the same jitter (grade
    'exact') and a rotation to the f32 floor.  The fields are the draw
    kernel's at each run's seeds (its plain version here), injected."""
    from xmca_tpu_torch.ops.syrk import pad_to

    H = tfast.hilbert_operator(N, torch.float32) if cplx else None
    for s in tsig.run_seeds(3, 2):
        fields, grams, mus = [], [], []
        for i, p in enumerate((P_L, P_R)):
            n_pad, p_pad = pad_to(N, p)
            X, _ = tsur.sign_field_sums((2 * s + i) & 0xFFFFFFFF, N, p,
                                        n_pad, p_pad, 'cpu')
            fields.append(X)
            Xf = X[:N, :p].to(torch.float32)
            mu = Xf.mean(dim=0)
            Xc = Xf - mu
            grams.append(tfast._fold_jitter(Xc @ Xc.T, p, tfast._F32_EPS, H))
            mus.append(mu)
        gen = torch.Generator().manual_seed(s)
        omega = tfast.start_block(
            N, K, torch.complex64 if cplx else torch.float32, gen)
        kw = dict(n_rot=K, power=1, tol=1e-8, n_iter=6, polar_method='ns')
        got = tfast.fast_surrogate_variance_tri(
            s, omega, N, (P_L, P_R), H=H, complexify=cplx, rotated=rotated,
            grade='exact', fields=fields, **kw)
        ref = tfast._surrogate_spectrum(
            grams, mus,
            lambda i, S: tfast._pm1_project(fields[i], S, (P_L, P_R)[i]),
            N, (P_L, P_R), H, rotated, omega, **kw)
        assert got[2] and ref[2]
        np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-4)


# ------------------------------------------------- rule_n configuration
_STATES = {}


def _solved_pair(cplx=True, rotated=True):
    """A JAX model and a port model holding one solution (solved once by
    the JAX package, then carried into fresh models of both)."""
    if (cplx, rotated) not in _STATES:
        rng = np.random.default_rng(4)
        jm = JMCA(rng.standard_normal((N, 60)), rng.standard_normal((N, 50)))
        jm.solve(complexify=cplx)
        if rotated:
            jm.rotate(3)
        _STATES[cplx, rotated] = to_state(jm)
    state = _STATES[cplx, rotated]
    jm, tm = JMCA(), TMCA(device='cpu')
    install_state(jm, state)
    install_state(tm, state)
    return jm, tm


class _Captured(Exception):
    pass


_KEYS = ('complexify', 'rotated', 'n_rot', 'power', 'tol', 'polar_method',
         'dtype', 'method', 'spectrum', 'n_modes_fast', 'subspace_iters',
         'surrogate_source', 'surrogate_dist')
PINNED = [
    dict(spectrum='fast', surrogate_source='generated',
         surrogate_gen_dist='rademacher8', ensemble_tol=1e-4,
         ensemble_subspace_iters=6, surrogate_dtype='float32'),
    dict(spectrum='exact', surrogate_source='draw',
         surrogate_gen_dist='normal16', ensemble_tol=1e-8,
         ensemble_subspace_iters=12, surrogate_dtype='float64'),
]
SETTINGS = [
    {}, dict(spectrum='exact'), dict(surrogate_source='draw'),
    dict(surrogate_source='draw', surrogate_dtype='float32'),
    dict(surrogate_gen_dist='normal32'),
    dict(surrogate_gen_dist='rademacher1', ensemble_tol=1e-5,
         ensemble_subspace_iters=3),
    dict(spectrum='exact', ensemble_tol=1e-4),
] + PINNED


def _jax_kwargs(monkeypatch, backend, settings, cplx, rotated, n_modes):
    monkeypatch.setattr(jax, 'default_backend', lambda: backend)
    jm, _ = _solved_pair(cplx, rotated)
    # a model built under the patched backend takes its spectrum default
    jm._ensemble_spectrum = 'fast' if backend == 'tpu' else 'exact'
    jm.set_solver(**settings)
    seen = {}

    def capture(*args, **kw):
        seen.update(kw)
        raise _Captured
    monkeypatch.setattr(jsig, 'rule_n_spectra', capture)
    with pytest.raises(_Captured):
        jm.rule_n(2, n_modes=n_modes, seed=1, disable_progress=True)
    return seen


@pytest.mark.parametrize('backend,settings',
                         [('tpu', s) for s in SETTINGS]
                         + [('cpu', s) for s in PINNED])
@pytest.mark.parametrize('cplx,rotated,n_modes', [(True, True, None),
                                                  (False, False, 5)])
def test_rule_n_config_matches_jax(monkeypatch, backend, settings, cplx,
                                   rotated, n_modes):
    """The port resolves every unset key as the JAX package does on a
    TPU, whatever the device; on another backend the two agree once the
    caller pins the keys that depend on it."""
    ref = _jax_kwargs(monkeypatch, backend, settings, cplx, rotated,
                      n_modes)
    _, tm = _solved_pair(cplx, rotated)
    tm.set_solver(**settings)
    got = tm._rule_n_config(n_modes)
    assert set(got) == set(_KEYS)
    for key in _KEYS:
        if key == 'dtype':
            assert str(got[key]).split('.')[-1] == np.dtype(ref[key]).name
        else:
            assert got[key] == ref[key], key


# ------------------------------------------------------ the draw source
def test_draw_source_seed_plumbing():
    """Run r draws its fields from a generator seeded with ``run_seeds(
    seed, n)[r] ^ DRAW_SALT``, its start block from one seeded with the
    run seed, and solves them with ``_surrogate_variance``."""
    kw = dict(complexify=True, rotated=True, n_rot=K, power=1, tol=1e-8,
              method='gram', spectrum='fast', n_modes_fast=K,
              subspace_iters=12, polar_method='ns')
    H = tfast.hilbert_operator(N, torch.float32)
    spectra, totals, iters = tsig.rule_n_spectra(
        N, (P_L, P_R), 3, dtype=torch.bfloat16, seed=9,
        surrogate_source='draw', device='cpu', H=H, **kw)
    assert spectra.shape == (3, K) and iters is None
    for r, s in enumerate(tsig.run_seeds(9, 3)):
        gen = torch.Generator().manual_seed(s ^ tsig.DRAW_SALT)
        fs = [torch.randn((N, p), generator=gen, dtype=torch.bfloat16)
              for p in (P_L, P_R)]
        omega = tfast.start_block(N, K, torch.complex64,
                                  torch.Generator().manual_seed(s))
        var, total, conv = tsig._surrogate_variance(
            fs, True, True, K, 1, 1e-8, 'gram', spectrum='fast',
            n_modes_fast=K, subspace_iters=12, omega=omega, hilbert_H=H,
            polar_method='ns')
        assert conv
        np.testing.assert_array_equal(spectra[r], var.numpy())
        assert totals[r] == float(total)


@pytest.mark.parametrize('cplx,rotated', [(False, False), (True, True)])
def test_rule_n_exact_spectrum_runs(cplx, rotated):
    """``set_solver(spectrum='exact')`` runs Rule-N on Gaussian fields in
    the model's dtype through the dense solve: every run kept, rescaled
    to the model's total."""
    _, tm = _solved_pair(cplx, rotated)
    tm.set_solver(spectrum='exact')
    null = tm.rule_n(3, n_modes=3, seed=2)
    assert null.shape == (3, 3) and np.isfinite(null).all()
    assert tm._rule_n_config()['dtype'] == torch.float64
    again = tm.rule_n(3, n_modes=3, seed=2)
    np.testing.assert_array_equal(null, again)
    if rotated:
        # each run's rotated variance is rescaled to the model's sum
        full = tm.rule_n(2, seed=2)
        np.testing.assert_allclose(full.sum(axis=0),
                                   tm.variance().sum(), rtol=1e-12)


def test_value_errors_match_jax():
    """'generated' needs the fast spectrum, in both packages and from the
    API; an unknown generated distribution is refused."""
    with pytest.raises(ValueError) as ref:
        jsig.rule_n_spectra(N, (P_L,), 1, surrogate_source='generated',
                            spectrum='exact', seed=1)
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        tsig.rule_n_spectra(N, (P_L,), 1, surrogate_source='generated',
                            spectrum='exact', seed=1)
    jm, tm = _solved_pair()
    for m in (jm, tm):
        m.set_solver(spectrum='exact', surrogate_source='generated')
        with pytest.raises(ValueError, match=re.escape(str(ref.value))):
            m.rule_n(2, seed=1)
    with pytest.raises(ValueError, match='unknown surrogate distribution'):
        tsig.rule_n_generated(N, (P_L,), 1, complexify=False, rotated=False,
                              n_rot=0, power=1, tol=1e-4, seed=1,
                              n_modes_fast=2, subspace_iters=2,
                              polar_method='ns14', device='cpu',
                              dist='uniform')
    with pytest.raises(ValueError, match='floating'):
        tm.set_solver(surrogate_dtype='int32')
    with pytest.raises(TypeError):
        tm.set_solver(surrogate_dtype='not-a-dtype')

"""The port's generated surrogate (draw map, K3/K4/K5 and
``fast_surrogate_variance_gen``) against the JAX package.

The JAX functions run un-jitted (``__wrapped__``) through their CPU path,
the XLA fallback of ``xmca_tpu/ops/surrogate.py``, with
``_xla_surrogate_field`` replaced by one that maps numpy-seeded 32-bit
words through the JAX package's own ``_bits_to_draw``; the port gets the
same words through its ``bits_to_draw``, so both sides see the same
fields.  The kernel-against-plain tests need an NVIDIA card (marker
``cuda``) and skip without one.  JAX is imported inside the tests that
use it, so the card's tests run where JAX is not installed:
``python -m pytest tests/unit/test_torch_gen.py -m cuda --noconftest``.
"""
import os

import numpy as np
import pytest
import torch

from xmca_tpu_torch.core import fastpath as tfast
from xmca_tpu_torch.ops import _build
from xmca_tpu_torch.ops.surrogate import (
    CHUNK_COLS, GEN_DISTS, GEN_STREAM, bits_to_draw, centered_gram_from_raw,
    chunk_plan, gram_from_chunks, gram_from_field, philox4x32_10,
    project_from_field, surrogate_field, surrogate_field_reference,
    surrogate_gram, surrogate_gram_reference, surrogate_project,
    surrogate_project_reference, words_reference)
from xmca_tpu_torch.ops.syrk import COL_PAD

N_OBS = 64
N_VARS = (300, 260)
SEED = 5
TOL_VAR = 2e-3       # f32 tail, mode-space iterate noise ~1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernel tests run on the card)')
    return torch.device('cuda')


def _words(seed, shape):
    """numpy-seeded uint32 words, with the extreme words included."""
    w = np.random.default_rng(seed).integers(0, 2 ** 32, size=shape,
                                             dtype=np.uint32)
    w.flat[:2] = (0, 0xFFFFFFFF)
    return w


def _torch_words(w):
    return torch.from_numpy(w.astype(np.int64))


def _patch_jax_field(monkeypatch, words_by_seed):
    """Route the JAX package's generated fields through numpy words and
    un-jit its two ops, so the fake sees concrete seeds (a jitted op would
    hand it a traced seed, and a cached trace could skip it)."""
    import jax.numpy as jnp
    import xmca_tpu.ops.surrogate as jsur
    calls = []

    def fake_field(seed, n, p, dist):
        calls.append(int(seed))
        w = words_by_seed[int(seed)]
        assert w.shape == (n, p)
        return jsur._bits_to_draw(jnp.asarray(w), dist)

    monkeypatch.setattr(jsur, '_xla_surrogate_field', fake_field)
    monkeypatch.setattr(jsur, 'surrogate_gram',
                        jsur.surrogate_gram.__wrapped__)
    monkeypatch.setattr(jsur, 'surrogate_project',
                        jsur.surrogate_project.__wrapped__)
    return jsur, calls


# ------------------------------------------------------------ draw map
@pytest.mark.parametrize('dist', GEN_DISTS)
def test_bits_to_draw_matches_jax(dist):
    """Exactly the JAX package's map, bf16 values compared as f32."""
    import jax.numpy as jnp
    from xmca_tpu.ops.surrogate import _bits_to_draw
    w = _words(1, (64, 1000))
    ref = _bits_to_draw(jnp.asarray(w), dist)
    got = bits_to_draw(_torch_words(w), dist)
    assert str(got.dtype).split('.')[-1] == str(ref.dtype)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(ref).astype(np.float32))


def test_bits_to_draw_refuses_unknown_dist():
    with pytest.raises(ValueError):
        bits_to_draw(torch.zeros(4, dtype=torch.int64), 'normal8')


def test_words_layout():
    """Element (r, c) is word c % 4 of Philox at counter (r, c // 4, 0, 0)
    under key (seed, GEN_STREAM)."""
    seed, n, p = 0x9E3779B97, 3, 11
    W = words_reference(seed, n, p)
    for r in range(n):
        for g in range(-(-p // 4)):
            lanes = [torch.tensor([v], dtype=torch.int64)
                     for v in (r, g, 0, 0)]
            out = philox4x32_10(*lanes, seed & 0xFFFFFFFF, GEN_STREAM)
            for k, word in enumerate(out):
                if 4 * g + k < p:
                    assert int(W[r, 4 * g + k]) == int(word)


# ------------------------------------------------- K3 and K4 algebra
@pytest.mark.parametrize('dist', ['normal32', 'rademacher8'])
def test_gram_from_field_matches_jax(monkeypatch, dist):
    """G, u and mumu within 1e-5 of max|G|, mu within 1e-6 (f64 sums
    here, f32 there); the centered Gram likewise."""
    n, p, seed = 96, 400, 21
    w = _words(2, (n, p))
    jsur, calls = _patch_jax_field(monkeypatch, {seed: w})
    Gj, muj, uj, mumuj = jsur.surrogate_gram(seed, n, p, dist=dist)
    Gcj = jsur.centered_gram_from_raw(Gj, uj, mumuj)
    assert calls == [seed]
    G, mu, u, mumu = gram_from_field(bits_to_draw(_torch_words(w), dist))
    scale = float(np.abs(np.asarray(Gj)).max())
    for got, ref in ((G, Gj), (u, uj), (mumu, mumuj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(mu.numpy(), np.asarray(muj), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(centered_gram_from_raw(G, u, mumu).numpy(),
                               np.asarray(Gcj), atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize('p, chunk_cols', [
    (1, 128), (128, 128), (129, 128), (1000, 256), (1024, 256),
    (100000, CHUNK_COLS), (8192, 8192), (16385, 8192), (300, 8192),
    (5000, 4096)])
def test_chunk_plan_covers_columns_once_in_order(p, chunk_cols):
    plan = chunk_plan(p, chunk_cols)
    p_pad = -(-p // COL_PAD) * COL_PAD
    assert plan[0][0] == 0
    assert sum(w for _, w in plan) == p_pad
    for (c0, w), (c1, _) in zip(plan, plan[1:]):
        assert c1 == c0 + w and w == chunk_cols
    assert all(0 < w <= chunk_cols and w % COL_PAD == 0 for _, w in plan)
    assert len(plan) == -(-p // chunk_cols)
    last0, last_w = plan[-1]
    assert last0 < p <= last0 + last_w


@pytest.mark.parametrize('chunk_cols', [0, 100, -128])
def test_chunk_plan_refuses_bad_chunks(chunk_cols):
    with pytest.raises(ValueError):
        chunk_plan(1000, chunk_cols)


@pytest.mark.parametrize('dist', ['normal32', 'rademacher', 'rademacher8'])
def test_gram_from_chunks_matches_jax(monkeypatch, dist):
    """The kernel's order of work in plain PyTorch (f32 chunk Grams summed
    in order, column sums per chunk, u and mu.mu from G) against the JAX
    package's surrogate_gram: four chunks of 256 columns, the last ragged.
    G within 1e-5 of max|G|, mu and u within 1e-6 (u of max|u|); +-1
    draws bit-equal (every sum is an exact integer).  mu.mu = 1^T G 1 / n^2
    (~14 here) cancels sums of |G| ~ 7e4, so it carries G's f32 rounding
    (7e-7 of it at this seed) where JAX's mu @ mu does not: each side is
    held within 1e-6 of the exact f64 value, so they agree within 2e-6."""
    n, p, seed = 70, 1000, 23
    w = _words(4, (n, p))
    jsur, calls = _patch_jax_field(monkeypatch, {seed: w})
    Gj, muj, uj, mumuj = (np.asarray(a) for a in
                          jsur.surrogate_gram(seed, n, p, dist=dist))
    assert calls == [seed]
    assert len(chunk_plan(p, 256)) == 4
    X = bits_to_draw(_torch_words(w), dist)
    G, mu, u, mumu = (a.numpy() for a in gram_from_chunks(X, 256))
    assert G.dtype == mu.dtype == u.dtype == np.float32
    if dist == 'normal32':
        scale = np.abs(Gj).max()
        np.testing.assert_allclose(G, Gj, atol=1e-5 * scale, rtol=0)
        np.testing.assert_allclose(mu, muj, atol=1e-6, rtol=0)
        np.testing.assert_allclose(u, uj, atol=1e-6 * np.abs(uj).max(),
                                   rtol=0)
        mu64 = X.to(torch.float64).mean(dim=0)
        exact = float(mu64 @ mu64)
        np.testing.assert_allclose(mumu, exact, rtol=1e-6)
        np.testing.assert_allclose(mumuj, exact, rtol=1e-6)
    else:
        np.testing.assert_array_equal(G, Gj)
        np.testing.assert_array_equal(mu * n, muj * n)


def test_project_from_field_matches_jax(monkeypatch):
    """X^T bf16(S) within 1e-5 of max|ref|: both round S to bf16."""
    import jax.numpy as jnp
    n, p, m, seed = 80, 256, 7, 9
    w = _words(3, (n, p))
    S = np.random.default_rng(0).standard_normal((n, m)).astype(np.float32)
    jsur, _ = _patch_jax_field(monkeypatch, {seed: w})
    ref = np.asarray(jsur.surrogate_project(seed, jnp.asarray(S), n, p))
    got = project_from_field(bits_to_draw(_torch_words(w), 'normal32'),
                             torch.from_numpy(S)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(),
                               rtol=0)


# ----------------------------------------------------------- the slice
def _run_gen_both(monkeypatch, *, complexify, rotated, n_rot,
                  dist='normal32', tol=1e-4):
    import jax
    import jax.numpy as jnp
    from xmca_tpu.core import fastpath as jfast
    words = {2 * SEED + i: _words(11 + i, (N_OBS, p))
             for i, p in enumerate(N_VARS)}
    _, calls = _patch_jax_field(monkeypatch, words)
    H = jfast.hilbert_imag_matrix(N_OBS, np.float32)
    key = jax.random.PRNGKey(SEED)
    kk = min(n_rot + 16, N_OBS)
    cdtype = jnp.complex64 if complexify else jnp.float32
    omega = np.array(jax.random.normal(key, (N_OBS, kk), jnp.float32)
                     .astype(cdtype))
    common = dict(complexify=complexify, rotated=rotated, n_rot=n_rot,
                  power=1, tol=tol, n_iter=6, polar_method='ns14',
                  dist=dist)
    var_j, tot_j, conv_j = jfast.fast_surrogate_variance_gen.__wrapped__(
        SEED, key, N_OBS, N_VARS, H=jnp.asarray(H) if complexify else None,
        **common)
    assert calls[:2] == [2 * SEED, 2 * SEED + 1]
    assert set(calls) == {2 * SEED, 2 * SEED + 1}

    fields = [bits_to_draw(_torch_words(words[2 * SEED + i]), dist)
              for i in range(len(N_VARS))]
    var_t, tot_t, conv_t, _ = tfast.fast_surrogate_variance_gen(
        SEED, torch.from_numpy(omega), N_OBS, N_VARS,
        H=torch.tensor(H) if complexify else None, fields=fields, **common)
    assert bool(conv_j) and conv_t
    return (np.asarray(var_j), float(tot_j)), (var_t.numpy(), float(tot_t))


@pytest.mark.parametrize('n_rot, space, tol', [(4, 'mode', 1e-4),
                                               (6, 'data', 1e-8)])
def test_gen_rotated_complex_matches_jax(monkeypatch, n_rot, space, tol):
    """The data-space case rotates to the f32 floor (tol 1e-8 clamps to
    100 eps): the complexified Gram has rank ~n/2 plus the jitter, so the
    f32 back-projection leaves ~1e-3 differences in the loadings of BOTH
    packages, and at the ensemble's 1e-4 the data-space varimax stops on
    a plateau whose position they move by ~2% (measured on these fields;
    both packages' rotations agree to 1e-6 on the same loadings)."""
    from xmca_tpu_torch.core.rotation import ensemble_space
    assert ensemble_space(sum(N_VARS), n_rot, 8) == space
    (var_j, tot_j), (var_t, tot_t) = _run_gen_both(
        monkeypatch, complexify=True, rotated=True, n_rot=n_rot, tol=tol)
    assert var_t.dtype == np.float32 and var_t.shape == (n_rot,)
    np.testing.assert_allclose(var_t, var_j, rtol=TOL_VAR)
    np.testing.assert_allclose(tot_t, tot_j, rtol=TOL_VAR)


def test_gen_rotated_real_matches_jax(monkeypatch):
    (var_j, tot_j), (var_t, tot_t) = _run_gen_both(
        monkeypatch, complexify=False, rotated=True, n_rot=4)
    np.testing.assert_allclose(var_t, var_j, rtol=TOL_VAR)
    np.testing.assert_allclose(tot_t, tot_j, rtol=TOL_VAR)


def test_gen_unrotated_complex_matches_jax(monkeypatch):
    """Unrotated: the leading singular values and the NS nuclear-norm
    total (f32 Cholesky + subspace iteration: 1e-4)."""
    (s_j, tot_j), (s_t, tot_t) = _run_gen_both(
        monkeypatch, complexify=True, rotated=False, n_rot=4)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-4)
    np.testing.assert_allclose(tot_t, tot_j, rtol=1e-4)


def test_gen_injected_fields_must_match_shape():
    bad = [torch.zeros((N_OBS, p + 1), dtype=torch.bfloat16)
           for p in N_VARS]
    with pytest.raises(ValueError):
        tfast.fast_surrogate_variance_gen(
            SEED, torch.zeros((N_OBS, 20)), N_OBS, N_VARS, fields=bad)


# ------------------------------------- the plain generator on its own
def test_field_is_deterministic_per_seed():
    a = surrogate_field(3, 32, 64, 'normal32', 'cpu')
    b = surrogate_field(3, 32, 64, 'normal32', 'cpu')
    c = surrogate_field(4, 32, 64, 'normal32', 'cpu')
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # the seed is taken modulo 2^32
    assert torch.equal(a, surrogate_field(3 + 2 ** 32, 32, 64, 'normal32',
                                          'cpu'))


@pytest.mark.parametrize('dist', GEN_DISTS)
def test_field_does_not_depend_on_its_extent(dist):
    """Each element depends only on (seed, row, column): a ragged field
    is the corner of a larger one, so no column >= p or row >= n feeds
    it and the kernels' zero pads hide nothing."""
    big = surrogate_field_reference(8, 40, 103, dist)
    small = surrogate_field_reference(8, 13, 21, dist)
    assert small.shape == (13, 21)
    assert torch.equal(small, big[:13, :21])


def test_zero_pads_contribute_nothing():
    """A zero-padded field (the kernels' masked tiles) gives the same
    Gram and projection as the field itself (all sums exact in f64)."""
    X = surrogate_field_reference(6, 50, 90, 'normal32')
    Xp = torch.zeros((64, 128), dtype=X.dtype)
    Xp[:50, :90] = X
    Gp = gram_from_field(Xp)[0]
    assert torch.equal(Gp[:50, :50], gram_from_field(X)[0])
    assert not Gp[50:].any() and not Gp[:, 50:].any()
    S = torch.randn((64, 5), generator=torch.Generator().manual_seed(0))
    S[50:] = 0
    assert torch.equal(project_from_field(Xp, S)[:90],
                       project_from_field(X, S[:50]))


@pytest.mark.parametrize('dist', ['normal32', 'normal16', 'rademacher'])
def test_draw_moments(dist):
    """Mirrors the JAX package's moment test: standardized, with the
    Binomial(b, 1/2) excess kurtosis -2/b."""
    X = surrogate_field_reference(17, 256, 2048, dist).to(torch.float64)
    assert abs(float(X.mean())) < 5e-3
    assert abs(float(X.var(unbiased=False)) - 1.0) < 5e-3
    kurt = {'normal32': 3.0 - 1.0 / 16.0, 'normal16': 3.0 - 1.0 / 8.0,
            'rademacher': 1.0}[dist]
    assert abs(float((X ** 3).mean())) < 2e-2
    assert abs(float((X ** 4).mean()) - kurt) < 5e-2


@pytest.mark.parametrize('dist', ['normal32', 'rademacher8'])
def test_plain_versions_agree_on_one_seed(dist):
    """K5's, K3's and K4's plain versions see one field."""
    n, p, seed = 48, 203, 12
    X = surrogate_field(seed, n, p, dist, 'cpu').to(torch.float64)
    G, mu, u, mumu = surrogate_gram(seed, n, p, dist, 'cpu')
    np.testing.assert_array_equal(G.numpy(),
                                  (X @ X.T).to(torch.float32).numpy())
    np.testing.assert_allclose(mu.numpy(), X.mean(0).numpy(), atol=1e-7)
    np.testing.assert_allclose(u.numpy(), (X @ X.mean(0)).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mumu), float(X.mean(0) @ X.mean(0)),
                               rtol=1e-6)
    S = torch.randn((n, 3), generator=torch.Generator().manual_seed(1))
    P = surrogate_project(seed, S, n, p, dist, 'cpu')
    Sb = S.to(torch.bfloat16).to(torch.float64)
    np.testing.assert_allclose(P.numpy(), (X.T @ Sb).numpy(), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------ wrappers
@pytest.mark.parametrize('call', [
    lambda: surrogate_field(1, 8, 8, 'gauss', 'cpu'),
    lambda: surrogate_gram(1, 8, 8, 'normal', 'cpu'),
    lambda: surrogate_field(1, 0, 8, 'normal32', 'cpu'),
    lambda: surrogate_gram(1, 8, 0, 'normal32', 'cpu'),
    lambda: surrogate_field(1, 8, 8, 'normal32', 'meta'),
    lambda: surrogate_project(1, torch.zeros((7, 2)), 8, 8, 'normal32',
                              'cpu'),
    lambda: surrogate_project(1, torch.zeros((8, 0)), 8, 8, 'normal32',
                              'cpu'),
])
def test_wrappers_refuse_bad_input(call):
    with pytest.raises(ValueError):
        call()


def test_project_refuses_non_f32():
    with pytest.raises(TypeError):
        surrogate_project(1, torch.zeros((8, 2), dtype=torch.float64), 8, 8,
                          'normal32', 'cpu')


def test_cpu_wrappers_launch_nothing():
    """On the CPU the wrappers take the plain versions: no launch is
    counted and no kernel library is built."""
    _build.reset_launch_counts()
    surrogate_field(4, 30, 50, 'normal16', 'cpu')
    surrogate_gram(4, 30, 50, 'rademacher', 'cpu')
    surrogate_project(4, torch.ones((30, 2)), 30, 50, 'normal32', 'cpu')
    assert _build.launch_counts() == {}
    assert _build._state['lib'] is None


def test_build_rebuilds_when_a_header_changes(tmp_path, monkeypatch):
    """A library newer than every source and header is kept; a header
    newer than the library triggers a rebuild (here: the call for nvcc,
    which this machine lacks)."""
    names = {os.path.basename(h) for h in _build.headers()}
    assert names == {'philox.cuh', 'gen_draw.cuh', 'syrk.cuh'}
    newest = max(os.path.getmtime(f)
                 for f in _build.sources() + _build.headers())
    lib = tmp_path / 'lib.so'
    lib.write_bytes(b'')
    os.utime(lib, (newest + 10, newest + 10))
    monkeypatch.setattr(_build, 'LIB_PATH', str(lib))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))

    def no_nvcc():
        raise RuntimeError('rebuild')
    monkeypatch.setattr(_build, '_nvcc', no_nvcc)
    assert _build.build() == ''
    header = tmp_path / 'changed.cuh'
    header.write_text('')
    os.utime(header, (newest + 20, newest + 20))
    monkeypatch.setattr(_build, 'headers', lambda: [str(header)])
    with pytest.raises(RuntimeError, match='rebuild'):
        _build.build()


# ------------------------------------------------ kernels on the card
@pytest.mark.cuda
@pytest.mark.parametrize('dist', GEN_DISTS)
@pytest.mark.parametrize('n, p', [(96, 400), (200, 3000), (1000, 4100),
                                  (7, 13)])
def test_field_kernel_matches_plain(cuda_device, dist, n, p):
    X = surrogate_field(31, n, p, dist, cuda_device)
    ref = surrogate_field_reference(31, n, p, dist, cuda_device)
    torch.cuda.synchronize()
    assert X.dtype == ref.dtype and torch.equal(X, ref)


@pytest.mark.cuda
@pytest.mark.parametrize('n, p', [
    (96, 400), (200, 3000), (130, 1001), (130, 100), (200, CHUNK_COLS),
    (130, 2 * CHUNK_COLS + 1), (6000, 2 * CHUNK_COLS + 1)])
def test_gram_kernel_matches_plain(cuda_device, n, p):
    """Chunk edges: p < 128, p = C, p = 2C + 1 (a one-column last
    chunk), n = 130 (a padded second tile row) and n = 6000 (eight whole
    waves of K1 on 132 SMs: its wave barrier)."""
    G, mu, u, mumu = surrogate_gram(2, n, p, 'normal32', cuda_device)
    Gr, mur, ur, mumur = surrogate_gram_reference(2, n, p, 'normal32',
                                                  cuda_device)
    torch.cuda.synchronize()
    scale = float(Gr.abs().max())
    assert float((G - Gr).abs().max()) <= 1e-5 * scale
    assert torch.equal(G, G.T)
    assert float((mu - mur).abs().max()) <= 1e-6
    assert float((u - ur).abs().max()) <= 1e-5 * float(ur.abs().max())
    assert abs(float(mumu - mumur)) <= 1e-5 * float(mumur)
    again = surrogate_gram(2, n, p, 'normal32', cuda_device)
    assert all(torch.equal(a, b) for a, b in zip((G, mu, u, mumu), again))
    for dist in ('rademacher', 'rademacher8'):
        Gi, mui, _, _ = surrogate_gram(2, n, p, dist, cuda_device)
        Gir, muir, _, _ = surrogate_gram_reference(2, n, p, dist,
                                                   cuda_device)
        assert torch.equal(Gi, Gir)
        assert float((mui - muir).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('chunk_cols', [128, 256, 1024])
def test_gram_kernel_chunk_sizes_agree(cuda_device, chunk_cols):
    """Any chunk width gives the plain chunked sums (rademacher exactly)."""
    n, p = 200, 3000
    G = surrogate_gram(6, n, p, 'normal32', cuda_device,
                       chunk_cols=chunk_cols)[0]
    Gr = gram_from_chunks(surrogate_field(6, n, p, 'normal32', cuda_device),
                          chunk_cols)[0]
    assert float((G - Gr).abs().max()) <= 1e-5 * float(Gr.abs().max())
    Gi = surrogate_gram(6, n, p, 'rademacher8', cuda_device,
                        chunk_cols=chunk_cols)[0]
    assert torch.equal(Gi, surrogate_gram_reference(6, n, p, 'rademacher8',
                                                    cuda_device)[0])


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 20, 37, 64])
def test_project_kernel_matches_plain(cuda_device, m):
    n, p = 200, 3001
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    S = torch.randn((n, m), generator=gen, device=cuda_device)
    P = surrogate_project(4, S, n, p, 'normal32', cuda_device)
    ref = surrogate_project_reference(4, S, n, p, 'normal32', cuda_device)
    torch.cuda.synchronize()
    assert float((P - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(P, surrogate_project(4, S, n, p, 'normal32',
                                            cuda_device))

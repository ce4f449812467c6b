"""The port's kernels' plain versions and wrappers (xmca_tpu_torch.ops).

On CPU tensors the wrappers run the plain PyTorch versions; these are
held against known answers and against the JAX package's Pallas syrk in
interpret mode.  The kernel-against-plain tests need an NVIDIA card
(marker ``cuda``) and skip without one; ``chip_smoke.py`` runs the same
comparisons at the main path's full shapes.  JAX is imported inside the
tests that use it, so the card's tests run where JAX is not installed:
``python -m pytest tests/unit/test_torch_ops.py -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

from xmca_tpu_torch.ops import _build
from xmca_tpu_torch.ops import syrk as syrk_module
from xmca_tpu_torch.ops.surrogate import (philox4x32_10, sign_field_sums,
                                          sign_field_sums_reference)
from xmca_tpu_torch.ops.syrk import (TILE, band_rows, pad_to, schedule,
                                     syrk, syrk_reference, tile_order,
                                     wave_counter, wave_panels, work_units,
                                     workspace_tiles)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernel tests run on the card)')
    return torch.device('cuda')


@pytest.mark.parametrize('ctr, key, expected', [
    ((0, 0, 0, 0), (0, 0), '6627e8d5 e169c58d bc57ac4c 9b00dbd8'),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     '408f276d 41c83b0e a20bc7c6 6d5451fd'),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0), 'd16cfe09 94fdcceb 5001e420 24126ea1'),
])
def test_philox_known_answers(ctr, key, expected):
    """Random123's Philox4x32-10 known-answer vectors, bit for bit."""
    lanes = [torch.tensor([c], dtype=torch.int64) for c in ctr]
    out = philox4x32_10(*lanes, *key)
    assert ' '.join('%08x' % int(o) for o in out) == expected


def test_sign_field_sums_reference_mask_and_sums():
    """+-1 in the live region, zero pads, exact int32 column sums, mean
    ~0, deterministic per seed (mirrors the JAX package's
    sign_field_sums test)."""
    n, p = 200, 3000
    n_pad, p_pad = pad_to(n, p)
    X, colsum = sign_field_sums_reference(11, n, p, n_pad, p_pad)
    assert X.shape == (n_pad, p_pad) and X.dtype == torch.int8
    assert colsum.shape == (p_pad,) and colsum.dtype == torch.int32
    Xn = X.numpy().astype(np.int64)
    assert set(np.unique(Xn[:n, :p])) == {-1, 1}
    assert (Xn[n:] == 0).all() and (Xn[:, p:] == 0).all()
    np.testing.assert_array_equal(colsum.numpy(), Xn.sum(axis=0))
    assert abs(Xn[:n, :p].mean()) < 5.0 / np.sqrt(n * p)
    X2, _ = sign_field_sums_reference(11, n, p, n_pad, p_pad)
    X3, _ = sign_field_sums_reference(12, n, p, n_pad, p_pad)
    assert torch.equal(X, X2)
    assert not torch.equal(X, X3)


def test_sign_field_sums_reference_row_blocks(monkeypatch):
    """Drawn in blocks of 7 rows (the last of 4, the pad rows from 200
    on inside one), the reference gives the one-block field and sums
    bit for bit."""
    from xmca_tpu_torch.ops import surrogate as sur
    n, p = 200, 3000
    n_pad, p_pad = pad_to(n, p)
    X, colsum = sign_field_sums_reference(11, n, p, n_pad, p_pad)
    monkeypatch.setattr(sur, '_REF_LANES', 7 * 32 * (p_pad // 128))
    Xb, colsum_b = sign_field_sums_reference(11, n, p, n_pad, p_pad)
    assert torch.equal(X, Xb) and torch.equal(colsum, colsum_b)


def test_sign_field_sums_bit_mapping():
    """Element (r, 128 g + 32 w + b) is bit b of Philox word w at
    counter (r, g, 0, 0) under key (seed ^ salt, 0)."""
    from xmca_tpu_torch.ops.surrogate import SIGN_SALT, SIGN_STREAM
    seed, r, g = 5, 3, 1
    X, _ = sign_field_sums_reference(seed, 128, 256, 128, 256)
    lanes = [torch.tensor([v], dtype=torch.int64) for v in (r, g, 0, 0)]
    words = philox4x32_10(*lanes, seed ^ SIGN_SALT, SIGN_STREAM)
    for w, word in enumerate(words):
        for b in range(32):
            bit = (int(word) >> b) & 1
            assert int(X[r, 128 * g + 32 * w + b]) == (1 if bit else -1)


def test_syrk_reference_matches_jax_syrk_int8():
    """Plain syrk == the JAX Pallas syrk (interpret mode) bit for bit on
    a +-1 int8 field with zero pads, at a multi-block shape."""
    import jax.numpy as jnp
    from xmca_tpu.ops.syrk import syrk as jax_syrk
    n, p = 1536, 1024
    rng = np.random.default_rng(1)
    X = rng.choice(np.array([-1, 1], np.int8), size=(n, p))
    X[1500:] = 0
    X[:, 1000:] = 0
    G_jax = np.asarray(jax_syrk(jnp.asarray(X), interpret=True))
    G = syrk(torch.from_numpy(X), pm1=True).numpy()
    np.testing.assert_array_equal(G, G_jax)
    np.testing.assert_array_equal(G, G.T)


def test_syrk_reference_int8_column_blocks(monkeypatch):
    """Summed over column blocks of 100 (the last of 56), the plain int8
    Gram is the exact one bit for bit."""
    from xmca_tpu_torch.ops import syrk as syrk_mod
    rng = np.random.default_rng(4)
    X = rng.integers(-127, 128, size=(128, 256)).astype(np.int8)
    X[:, 250:] = 0
    monkeypatch.setattr(syrk_mod, '_REF_BYTES', 8 * 128 * 100)
    G = syrk_reference(torch.from_numpy(X)).numpy()
    exact = X.astype(np.int64) @ X.astype(np.int64).T
    np.testing.assert_array_equal(G, exact.astype(np.float32))


def test_syrk_reference_matches_jax_syrk_bf16():
    """Plain syrk == the JAX Pallas syrk on +-1 bf16 (exact in both)."""
    import jax.numpy as jnp
    from xmca_tpu.ops.syrk import syrk as jax_syrk
    n, p = 1536, 1024
    rng = np.random.default_rng(2)
    X = rng.choice([-1.0, 1.0], size=(n, p)).astype(np.float32)
    X[1400:] = 0.0
    G_jax = np.asarray(jax_syrk(jnp.asarray(X, jnp.bfloat16),
                                interpret=True))
    G = syrk(torch.from_numpy(X).to(torch.bfloat16)).numpy()
    np.testing.assert_array_equal(G, G_jax)


def test_syrk_reference_int8_exact_beyond_pm1():
    """int8 values up to 127 sum exactly (f64 products of int8 are exact)
    and round to f32 like the kernel's int32 -> f32 store."""
    rng = np.random.default_rng(3)
    X = rng.integers(-127, 128, size=(128, 256)).astype(np.int8)
    G = syrk_reference(torch.from_numpy(X)).numpy()
    exact = X.astype(np.int64) @ X.astype(np.int64).T
    np.testing.assert_array_equal(G, exact.astype(np.float32))


@pytest.mark.parametrize('make, err', [
    (lambda: torch.zeros((128, 128), dtype=torch.float32), TypeError),
    (lambda: torch.zeros(128, dtype=torch.int8), TypeError),
    (lambda: torch.zeros((128, 256), dtype=torch.int8)[:, ::2], ValueError),
    (lambda: torch.zeros((100, 128), dtype=torch.int8), ValueError),
    (lambda: torch.zeros((128, 100), dtype=torch.bfloat16), ValueError),
    (lambda: torch.zeros((128, 133248), dtype=torch.int8), ValueError),
])
def test_syrk_refusals(make, err):
    """Wrong dtype or rank, non-contiguous, unpadded, and int8 whose
    worst case p_pad * 127^2 reaches 2^31 without pm1=True."""
    with pytest.raises(err):
        syrk(make())


def test_syrk_pm1_lifts_overflow_guard():
    X = torch.zeros((128, 133248), dtype=torch.int8)
    assert syrk(X, pm1=True).shape == (128, 128)


def test_sign_field_sums_refuses_unpadded():
    with pytest.raises(ValueError):
        sign_field_sums(1, 100, 100, 100, 128, 'cpu')
    with pytest.raises(ValueError):
        sign_field_sums(1, 200, 100, 128, 128, 'cpu')


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers take the plain versions: no launch is
    counted and no kernel library is built."""
    _build.reset_launch_counts()
    X, _ = sign_field_sums(4, 100, 300, *pad_to(100, 300), 'cpu')
    syrk(X, pm1=True)
    assert _build.launch_counts() == {}
    assert _build._state['lib'] is None


def _check_schedule(n_pad, p_pad, elem_bytes, sms, band=None):
    s = schedule(n_pad, p_pad, elem_bytes, sms)
    nb = n_pad // TILE
    assert s.tiles == nb * (nb + 1) // 2
    assert s.kblocks == p_pad * elem_bytes // 128
    assert s.grid <= sms and s.dp_tiles + s.split_tiles == s.tiles
    assert s.split_tiles * s.splits <= s.grid
    cover = {}
    loads = []
    for b in range(s.grid):
        units = work_units(s, b)
        loads.append(sum(k1 - k0 for _, k0, k1, _ in units))
        for t, k0, k1, slot in units:
            assert 0 <= k0 < k1 <= s.kblocks
            assert (slot < 0) == (t < s.dp_tiles)
            cover.setdefault(t, []).append((k0, k1, slot))
    assert sorted(cover) == list(range(s.tiles))
    slots = []
    for t, pieces in cover.items():
        assert len(pieces) == (1 if t < s.dp_tiles else s.splits)
        bounds = [k for k0, k1, _ in pieces for k in (k0, k1)]
        assert bounds[0] == 0 and bounds[-1] == s.kblocks
        assert all(bounds[i] == bounds[i + 1]
                   for i in range(1, len(bounds) - 1, 2))
        slots += [slot for _, _, slot in pieces if slot >= 0]
    assert sorted(slots) == list(range(workspace_tiles(s)))
    if s.dp_tiles:
        # the split tail adds at most one piece to a block's full waves
        assert max(loads) - min(loads) <= -(-s.kblocks // s.splits)
    order = tile_order(n_pad, sms, band)
    assert len(order) == s.tiles and len(set(order)) == s.tiles
    assert all(0 <= j <= i < nb for i, j in order)


@pytest.mark.parametrize('n_pad, p_pad', [(128, 128), (256, 3072),
                                          (2048, 100096), (4096, 20096)])
@pytest.mark.parametrize('elem_bytes', [1, 2])
def test_syrk_schedule_covers_every_tile_once(n_pad, p_pad, elem_bytes):
    """The kernel's work list on a 132-SM card: every lower-triangle
    tile is computed once, whole or as pieces that cover its contraction
    blocks exactly once in order; no block idles a whole wave while
    another has work; the workspace holds one tile per piece."""
    _check_schedule(n_pad, p_pad, elem_bytes, 132)


# the 14610-step record, the fold's 8192 steps, and 47 tile rows, which
# no band height of the sweep divides
@pytest.mark.parametrize('n_pad, p_pad', [(14720, 100096), (8192, 100096),
                                          (6016, 8064)])
@pytest.mark.parametrize('band', [None, 1, 4, 8, 12, 16])
def test_syrk_schedule_covers_every_tile_once_long(n_pad, p_pad, band):
    """As above at multi-wave shapes, for each band height of the tile
    order (None: the default, 11 tile rows on 132 SMs)."""
    _check_schedule(n_pad, p_pad, 1, 132, band)


@pytest.mark.parametrize('n_pad', [128, 1536, 6016, 14720])
@pytest.mark.parametrize('sms, band', [(132, None), (132, 1), (132, 5),
                                       (132, 200), (32, None), (7, 3)])
def test_syrk_tile_order_bands(n_pad, sms, band):
    """The order walks bands of tile rows whose heights differ by at
    most one, each column by column, top down: g = 1 is the row-major
    walk of the triangle and a band as high as the triangle its
    column-major walk."""
    nb = n_pad // TILE
    order = tile_order(n_pad, sms, band)
    g = min(band or band_rows(sms), nb)
    n_bands = -(-nb // g)
    heights = [nb // n_bands + (b < nb % n_bands) for b in range(n_bands)]
    assert max(heights) <= g
    pos = r0 = 0
    for h in heights:
        # rows [r0, r0 + h): h * r0 full-height columns, then a triangle
        size = h * r0 + h * (h + 1) // 2
        walk = order[pos:pos + size]
        assert sorted(walk) == [(i, j) for i in range(r0, r0 + h)
                                for j in range(i + 1)]
        assert walk == sorted(walk, key=lambda ij: (ij[1], ij[0]))
        pos, r0 = pos + size, r0 + h
    assert pos == len(order)
    if g == 1:
        assert order == [(i, j) for i in range(nb) for j in range(i + 1)]
    if g == nb:
        assert order == [(i, j) for j in range(nb) for i in range(j, nb)]


def test_syrk_tile_order_long_shape_wave_panels():
    """At the 14610-step record's (14720, 100096) on 132 SMs, each of
    the 50 whole waves of the default order reads at most 32 distinct
    row panels of X, 26 on average; the row-major order (band 1) reads
    up to 115, 78 on average."""
    assert band_rows(132) == 11
    grouped = wave_panels(14720, 132)
    row_major = wave_panels(14720, 132, band=1)
    assert len(grouped) == len(row_major) == 50
    assert max(grouped) <= 32 and np.mean(grouped) <= 26
    assert max(row_major) == 115 and round(np.mean(row_major)) == 78
    fold = wave_panels(8192, 132)
    assert len(fold) == 15 and max(fold) <= 32


@pytest.mark.parametrize('n_pad, barrier', [
    (128, False), (2048, False), (2816, False), (2944, True), (4096, True),
    (14720, True)])
def test_syrk_wave_barrier_from_two_whole_waves(monkeypatch, n_pad,
                                                barrier):
    """The kernel gets a wave counter (4 bytes) where its schedule has
    two whole waves or more on 132 SMs (22 tile rows: 253 tiles, one
    wave; 23: 276, two), and none when the module turns it off."""
    s = schedule(n_pad, 100096, 1, 132)
    waves = wave_counter(s, 'cpu')
    assert (waves is not None) == barrier == (s.dp_tiles >= 2 * s.grid)
    if barrier:
        assert waves.dtype == torch.int32 and waves.numel() == 1
    monkeypatch.setattr(syrk_module, '_WAVE_BARRIER', False)
    assert wave_counter(s, 'cpu') is None


@pytest.mark.parametrize('band', [None, 1, 4])
def test_syrk_schedule_emulation_matches_jax_syrk(band):
    """The kernel's schedule walked on the CPU: every block's units in
    its order, at (1536, 1024) int8 on 32 SMs (78 tiles: two whole waves
    and 14 tiles split in two).  A whole tile's product goes to G and its
    mirror (a diagonal tile's lower half), a piece's to its workspace
    slot, and the pieces of each split tile are summed in order 0, 1, ...
    in int32, as the kernel and split_sum_kernel do.  G is bit-equal to
    the JAX package's Pallas syrk in interpret mode."""
    import jax.numpy as jnp
    from xmca_tpu.ops.syrk import pad_to as jax_pad_to
    from xmca_tpu.ops.syrk import syrk as jax_syrk
    n, p, sms = 1536, 1024, 32
    assert jax_pad_to(n, p) == pad_to(n, p) == (n, p)
    rng = np.random.default_rng(4)
    X = rng.choice(np.array([-1, 1], np.int8), size=(n, p))
    X[1500:] = 0
    X[:, 1000:] = 0
    s = schedule(n, p, 1, sms)
    assert (s.dp_tiles, s.split_tiles, s.splits) == (64, 14, 2)
    order = tile_order(n, sms, band)
    Xi = X.astype(np.int32)
    G = np.zeros((n, n), np.float32)
    work = np.zeros((workspace_tiles(s), TILE, TILE), np.int32)
    lower = np.tri(TILE, dtype=bool)

    def store(ti, tj, tile):
        r, c = slice(ti * TILE, ti * TILE + TILE), slice(tj * TILE,
                                                         tj * TILE + TILE)
        keep = lower if ti == tj else np.ones_like(lower)
        G[r, c] = np.where(keep, tile, G[r, c])
        G[c, r] = np.where(keep.T, tile.T, G[c, r])

    for b in range(s.grid):
        for t, k0, k1, slot in work_units(s, b):
            ti, tj = order[t]
            k = slice(k0 * 128, k1 * 128)     # int8: 128 columns a block
            part = (Xi[ti * TILE:ti * TILE + TILE, k]
                    @ Xi[tj * TILE:tj * TILE + TILE, k].T)
            if slot < 0:
                store(ti, tj, part.astype(np.float32))
            else:
                work[slot] = part
    for y in range(s.split_tiles):
        total = np.zeros((TILE, TILE), np.int32)
        for i in range(s.splits):
            total += work[y * s.splits + i]
        store(*order[s.dp_tiles + y], total.astype(np.float32))
    G_jax = np.asarray(jax_syrk(jnp.asarray(X), interpret=True))
    np.testing.assert_array_equal(G, G_jax)


def test_syrk_schedule_main_path_shape():
    """At the main path's (2048, 100096) int8: 136 tiles, one whole
    wave of 132 and 4 tiles cut into 33 pieces of ~24 blocks each."""
    s = schedule(2048, 100096, 1, 132)
    assert s == (136, 782, 132, 132, 4, 33)
    assert workspace_tiles(s) == 132
    assert schedule(4096, 20096, 1, 132)[2:] == (132, 528, 0, 1)
    assert schedule(128, 128, 1, 132)[2:] == (1, 0, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize('n, p', [(128, 128), (200, 3000), (1000, 4100),
                                  (4000, 20000), (300, 128), (130, 5000)])
def test_syrk_kernel_matches_plain_int8(cuda_device, n, p):
    n_pad, p_pad = pad_to(n, p)
    X, _ = sign_field_sums(9, n, p, n_pad, p_pad, cuda_device)
    G = syrk(X, pm1=True)
    torch.cuda.synchronize()
    assert torch.equal(G, syrk_reference(X))
    Xb = X.to(torch.bfloat16)
    assert torch.equal(syrk(Xb), syrk_reference(Xb))


@pytest.mark.cuda
def test_syrk_kernel_matches_plain_bf16(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    X = torch.randn((384, 1024), generator=gen, device=cuda_device)
    X = X.to(torch.bfloat16)
    G = syrk(X)
    ref = syrk_reference(X)
    torch.cuda.synchronize()
    # f32 sums of 1024 products in another order: ~1e-6 relative
    assert torch.allclose(G, ref, rtol=1e-5, atol=1e-3)
    assert torch.equal(G, G.T)


@pytest.mark.cuda
@pytest.mark.parametrize('n, p', [(130, 20096), (2000, 100000)])
def test_syrk_kernel_bf16_randn_split_tiles(cuda_device, n, p):
    """bf16 N(0,1) through a padded second tile row (n = 130) and
    through the split tail (n_pad = 2048): within 1e-4 of max|G| (f32
    sums in another order, the kernel's folded every kFoldBlocks = 4
    contraction blocks, 256 products), exactly symmetric, the same bits
    on a second run."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    X = torch.zeros(pad_to(n, p), dtype=torch.bfloat16, device=cuda_device)
    X[:n, :p] = torch.randn((n, p), generator=gen, device=cuda_device)
    G, ref = syrk(X), syrk_reference(X)
    torch.cuda.synchronize()
    assert float((G - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(G, G.T) and torch.equal(G, syrk(X))


@pytest.mark.cuda
def test_syrk_kernel_multi_wave_ragged(cuda_device):
    """(6000, 8000) +-1: 47 tile rows in bands of 11 and 12 (1128 tiles,
    8 whole waves and 72 split tiles on 132 SMs), int8 and bf16 bit-equal
    to the plain version."""
    n, p = 6000, 8000
    X, _ = sign_field_sums(13, n, p, *pad_to(n, p), cuda_device)
    G = syrk(X, pm1=True)
    torch.cuda.synchronize()
    assert torch.equal(G, syrk_reference(X))
    Xb = X.to(torch.bfloat16)
    assert torch.equal(syrk(Xb), syrk_reference(Xb))


@pytest.mark.cuda
@pytest.mark.parametrize('n, p', [(128, 128), (200, 3000), (2000, 5000)])
def test_sign_field_kernel_matches_plain(cuda_device, n, p):
    n_pad, p_pad = pad_to(n, p)
    X, s = sign_field_sums(21, n, p, n_pad, p_pad, cuda_device)
    Xr, sr = sign_field_sums_reference(21, n, p, n_pad, p_pad, cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(X, Xr) and torch.equal(s, sr)

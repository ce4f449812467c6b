"""The port's device mesh (``xmca_tpu_torch.parallel``) against the JAX
package's, on the CPU in float64.

The port side runs in ONE job of 4 gloo ranks (``torch.multiprocessing``,
``device='cpu'``, a process-group timeout), spawned once for the module;
the job imports only torch and the port (JAX is imported inside the
tests) and drives every case on meshes (1, 4), (4, 1) and (2, 2), each
rank pickling what it holds.  The JAX side of each case runs here, on
the first 4 of the 8 virtual devices of ``tests/conftest.py``, with the
same mesh shape.

Each case of ``tests/integration/test_mesh.py`` has its counterpart at
that test's own tolerance (1e-9 to 1e-10 on spectra, 1e-8 on |V|),
against JAX where both packages compute from the same inputs (injected
start blocks, a carried state, one resampling block spanning the axis)
and otherwise against the port's own unsharded run with JAX's sharded
and unsharded runs held as its test holds them (Monte-Carlo draws differ
between the packages).  Ensemble-only meshes equal the unsharded port
exactly.  ``__graft_entry__.dryrun_multichip``'s flow runs at its size
(256 x 32 x 128) on the (2, 2) mesh with its thresholds, and so do the
mesh paths the JAX tests leave out: boundary extension, the iterative
in-memory bootstrap and the streamed bootstrap on both axes.  A JAX
solution carried into port models bootstraps with one block spanning
the time axis or the columns of the space-sharded fields, and with its
runs split over the space axis, against JAX on (2, 2) and (1, 4); the
sharded column resamples (each rank its draws on its own columns) and
the runs split over the space axis against the unsharded port.  On a
world-1 gloo group in this process: ``make_mesh``'s ``ValueError``,
``distribute_array``'s shards and its uneven-width ``ValueError``, and a
(1, 1) mesh equal to no mesh.
"""
import contextlib
import os
import pickle
import socket
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from xmca_tpu_torch.array import MCA as TMCA
from xmca_tpu_torch.core import fastpath as tfast
from xmca_tpu_torch.core import streaming as tstream
from xmca_tpu_torch.parallel import mesh as tmesh
from xmca_tpu_torch.parallel import distribute_array, make_mesh
from xmca_tpu_torch.stats import significance as tsig
from xmca_tpu_torch.utils.state import install_state
from xmca_tpu_torch.xarray import xMCA as TxMCA

WORLD = 4
MESHES = {'space': (1, 4), 'ensemble': (4, 1), 'both': (2, 2)}
TIMEOUT_S = 180
N_OBS = 64                     # the grid fields' steps (8 x 20 cells)
DRY = (256, 32, 128)           # dryrun_multichip's size


# ----------------------------------------------------------------- inputs
def _xy():
    rng = np.random.default_rng(0)
    Xl = rng.standard_normal((96, 64))
    Xr = rng.standard_normal((96, 48))
    return Xl - Xl.mean(0), Xr - Xr.mean(0)


def _big_xy():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((512, 8))
    Xl = base @ rng.standard_normal((8, 8192)) \
        + 0.5 * rng.standard_normal((512, 8192))
    Xr = base @ rng.standard_normal((8, 8192)) \
        + 0.5 * rng.standard_normal((512, 8192))
    return Xl - Xl.mean(0), Xr - Xr.mean(0)


def _grid(n_obs=N_OBS, n_lat=8, n_lon=20, seeds=(1, 2)):
    """(time, lat, lon) fields: 8 shared sinusoidal modes plus noise."""
    t = np.arange(n_obs, dtype=np.float64)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 9)[None] / n_obs)
    out = []
    for seed in seeds:
        r = np.random.default_rng(seed)
        p = n_lat * n_lon
        data = modes @ r.standard_normal((8, p)) + r.standard_normal(
            (n_obs, p))
        out.append(data.reshape(n_obs, n_lat, n_lon))
    return out


def _dry_fields():
    """``dryrun_multichip``'s two fields (its seeds and modes), float64,
    with their coordinates."""
    n_obs, n_lat, n_lon = DRY
    modes = np.sin(2 * np.pi * np.arange(n_obs, dtype=np.float32)[:, None]
                   * np.arange(1, 7)[None, :] / n_obs).astype(np.float32)
    modes = modes * np.asarray([10.0, 7.0, 5.0, 3.5, 2.5, 1.8],
                               np.float32)[None, :]
    coords = {'time': np.arange(n_obs, dtype=np.float64),
              'lat': np.linspace(-60, 60, n_lat),
              'lon': np.linspace(0, 359, n_lon)}
    out = []
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        p = n_lat * n_lon
        data = modes @ r.standard_normal((6, p), dtype=np.float32)
        data += r.standard_normal((n_obs, p), dtype=np.float32)
        out.append(data.reshape(n_obs, n_lat, n_lon).astype(np.float64))
    return out, coords


def _stream_xy():
    Xl, Xr = (x.copy() for x in _xy())
    Xl[:, 5] = np.nan
    Xr[:, [2, 40]] = np.nan
    return Xl, Xr


def _loader(X, width):
    return lambda: tstream.chunks_from_array(X, width)


def _wide_loader(A, width):
    def chunks():
        for s in range(0, A.shape[1], width):
            yield A[:, s:s + width]
    return chunks


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return np.asarray(getattr(x, 'values', x))


def _dry_da(arrays, coords):
    from xmca_tpu_torch.compat import xr
    return [xr.DataArray(a, dims=('time', 'lat', 'lon'), coords=coords)
            for a in arrays]


# ----------------------------------------------------- the port's 4 ranks
def _case_solve(mesh):
    Xl, Xr = _xy()
    s, Vl, Vr = tmesh.sharded_solve(Xl, Xr, mesh=mesh)
    return {'s': s.numpy(), 'Vl': Vl.numpy(), 'Vr': Vr.numpy(),
            'shard': tuple(distribute_array(_t(Xl), mesh).shape)}


def _case_rule_n(mesh):
    """The default +-1 Rule-N and 'normal16' fields (the field kernel's
    plain version here), each unsharded and split over ``mesh``."""
    out = {}
    for dist_name in ('rademacher8', 'normal16'):
        m = TMCA(*_grid(), device='cpu')
        m.set_solver(surrogate_gen_dist=dist_name)
        m.solve()
        plain = _np(m.rule_n(8, seed=99))
        m.set_solver(mesh=mesh, surrogate_gen_dist=dist_name)
        out[dist_name] = {'plain': plain,
                          'sharded': _np(m.rule_n(8, seed=99))}
    return out


def _case_bootstrap(mesh):
    m = TMCA(*_grid(), device='cpu')
    m.solve()
    plain = m.bootstrapping(8, 3, disable_progress=True, seed=5)
    m.set_solver(mesh=mesh)
    return {'plain': plain,
            'sharded': m.bootstrapping(8, 3, disable_progress=True, seed=5)}


# the carried-state bootstraps: (ensemble_axis, axis, on_left, on_right,
# strategy); one block spans the resampled axis (the time axis, or the
# concatenation of the resampled fields' columns), so every run resamples
# nothing and both packages solve the same data
N_COLS = 160                   # the grid fields' packed columns
BOOT_STATE = {
    'standard': ('ensemble', 0, True, False, 'standard'),
    'iterative': ('ensemble', 0, True, False, 'iterative'),
    'axis1_left': ('ensemble', 1, True, False, 'standard'),
    'axis1_right': ('ensemble', 1, False, True, 'standard'),
    'axis1_both': ('ensemble', 1, True, True, 'standard'),
    'axis1_both_iterative': ('ensemble', 1, True, True, 'iterative'),
    'space_standard': ('space', 0, True, False, 'standard'),
    'space_iterative': ('space', 0, True, False, 'iterative'),
}


def _boot_state_kw(name):
    ens, axis, on_left, on_right, strategy = BOOT_STATE[name]
    span = N_OBS if axis == 0 else N_COLS * (on_left + on_right)
    return ens, dict(n_modes=3, axis=axis, on_left=on_left,
                     on_right=on_right, block_size=span, strategy=strategy,
                     seed=4)


def _case_boot_state(mesh, state, names):
    """A JAX solution carried into a port model on the mesh: the
    bootstraps ``names`` of BOOT_STATE, exact spectrum, tol 1e-8
    (comparable to JAX's)."""
    out = {}
    for name in names:
        ens, kw = _boot_state_kw(name)
        m = TMCA(device='cpu')
        m.set_solver(mesh=mesh, ensemble_axis=ens, spectrum='exact',
                     ensemble_tol=1e-8)
        install_state(m, state)
        out[name] = m.bootstrapping(3, **kw)
    return out


def _boot_axis_model(mesh, extend=False):
    """A normalized, complexified, promax-rotated model of the grid
    fields (a truncated fold solve; ``extend``: a dense extended one) on
    ``mesh`` or on none."""
    m = TMCA(*_grid(seeds=(12, 13)), device='cpu')
    m.set_solver(mesh=mesh, **({} if extend else {'truncate': 6}))
    m.normalize()
    m.solve(complexify=True, extend=extend, period=12)
    m.rotate(4, power=2)
    return m


# the space-sharded bootstraps held against the unsharded port: name ->
# (extend, ensemble_axis, bootstrapping's keywords)
BOOT_AXIS = {
    'left': (False, 'ensemble', dict(axis=1, block_size=1)),
    'right': (False, 'ensemble', dict(axis=1, on_left=False, on_right=True,
                                      block_size=4)),
    # two blocks of half the field: a run that draws one twice leaves
    # the ranks of the other half with no column
    'left_halves': (False, 'ensemble', dict(axis=1, block_size=80)),
    'both': (False, 'ensemble', dict(axis=1, on_right=True, block_size=1)),
    'both_perm': (False, 'ensemble', dict(axis=1, on_right=True,
                                          block_size=8, replace=False)),
    'left_iterative': (False, 'ensemble', dict(axis=1, block_size=1,
                                               strategy='iterative')),
    'both_iterative': (False, 'ensemble', dict(axis=1, on_right=True,
                                               block_size=2,
                                               strategy='iterative')),
    'both_extend': ('exp', 'ensemble', dict(axis=1, on_right=True,
                                            block_size=2)),
    'space_standard': (False, 'space', dict(block_size=2)),
    'space_iterative': (False, 'space', dict(block_size=2,
                                             strategy='iterative')),
    'space_axis1': (False, 'space', dict(axis=1, on_right=True,
                                         block_size=4)),
}


def _boot_axis_runs(mesh):
    """Every BOOT_AXIS bootstrap (4 runs, 3 modes, seed 21)."""
    models, out = {}, {}
    for name, (extend, ens, kw) in BOOT_AXIS.items():
        if extend not in models:
            models[extend] = _boot_axis_model(mesh, extend)
        m = models[extend]
        m.set_solver(ensemble_axis=ens)
        out[name] = m.bootstrapping(4, n_modes=3, seed=21, **kw)
    return out


def _case_2d(mesh):
    kw = dict(dtype=torch.float64, seed=0, spectrum='exact',
              surrogate_source='draw')
    return {'sharded': tsig.rule_n_spectra(64, (32, 24), 4, mesh=mesh,
                                           **kw),
            'plain': tsig.rule_n_spectra(64, (32, 24), 4, **kw)}


def _case_fast_trunc(mesh, omega):
    Xl, Xr = (distribute_array(_t(x), mesh) for x in _big_xy())
    with tmesh.space_context(mesh):
        s, Vl, Vr, _, _ = tfast.fast_solve_truncated_totals(
            Xl, Xr, _t(omega), n_modes=10, n_iter=10)
    return {'s': s.numpy(), 'Vl': Vl.numpy(), 'Vr': Vr.numpy()}


def _case_fast_rot(mesh, omega):
    Xl, Xr = (distribute_array(_t(x), mesh) for x in _big_xy())
    with tmesh.space_context(mesh):
        var, conv = tfast.fast_rotated_variance(
            Xl, Xr, _t(omega), n_rot=8, power=1, n_iter=10)
    return {'var': var.numpy(), 'conv': conv}


def _case_fast_rot_analytic(mesh, omega):
    Xl, Xr = (distribute_array(_t(x), mesh) for x in _big_xy())
    H = tfast.hilbert_operator(512, torch.float64)
    with tmesh.space_context(mesh):
        var, conv = tfast.fast_rotated_variance_analytic(
            Xl, Xr, H, _t(omega), n_rot=8, n_iter=10, tol=1e-5)
    return {'var': var.numpy(), 'conv': conv}


def _case_streamed(mesh):
    Xl, Xr = _stream_xy()
    out = {}
    for cplx in (False, True):
        r = tstream.streamed_mca(_loader(Xl, 13), _loader(Xr, 13), 96, 5,
                                 complexify=cplx, mesh=mesh)
        p = {k: int(r.keep[k].sum()) for k in r.keep}
        out[cplx] = {
            'svals': r.svals, 'total': r.total_covariance,
            'keep': r.keep, 'means': r.means,
            'V_left': tmesh.gather_rows(r.V_left, r.cols['left'],
                                        p['left'], mesh).numpy(),
            'V_right': tmesh.gather_rows(r.V_right, r.cols['right'],
                                         p['right'], mesh).numpy(),
            'scores_left': r.scores_left.numpy()}
    return out


def _fold_model(mesh):
    left, right = _grid(48, 8, 16, seeds=(3, 4))
    m = TMCA(left, right, device='cpu')
    m.set_solver(truncate=5, mesh=mesh)
    m.solve(complexify=True)
    m.rotate(4)
    return m


def _case_fold_api(mesh):
    m = _fold_model(mesh)
    return {'s': m.singular_values(5), 'var': m.variance(4)}


def _stream_api_model(mesh):
    rng = np.random.default_rng(7)
    X = {k: rng.standard_normal((64, 30 * 11)) for k in ('l', 'r')}
    m = TMCA.from_chunks(_wide_loader(X['l'], 37), _wide_loader(X['r'], 37),
                         n_observations=64, left_shape=(30, 11),
                         right_shape=(30, 11), device='cpu')
    m.set_solver(truncate=4, mesh=mesh)
    m.solve()
    return m


def _case_stream_api(mesh):
    m = _stream_api_model(mesh)
    return {'s': m.singular_values(), 'eofs': m.eofs(4, rotated=False)}


def _extend_model(mesh, extend):
    left, right = _grid(48, 8, 16, seeds=(5, 6))
    m = TMCA(left, right, device='cpu')
    if mesh is not None:
        m.set_solver(mesh=mesh)
    m.solve(complexify=True, extend=extend, period=12)
    m.rotate(3)
    return m


def _case_extend(mesh):
    out = {}
    for extend in ('exp', 'theta'):
        m = _extend_model(mesh, extend)
        out[extend] = {'s': m.singular_values(6), 'var': m.variance(3),
                       'eofs': m.eofs(3), 'pcs': m.pcs(3)}
    return out


def _boot_models(mesh):
    """The in-memory model and a chunk-backed one of the same data
    (normalized, complexified, rotated), on ``mesh`` or on none."""
    left, right = _grid(64, 8, 20, seeds=(8, 9))
    # two NaN columns: the packed width (158) divides over the shards
    left[:, 0, 3] = left[:, 5, 7] = np.nan
    models = []
    for backed in (False, True):
        if backed:
            m = TMCA.from_chunks(
                _wide_loader(left.reshape(64, -1), 37),
                _wide_loader(right.reshape(64, -1), 23),
                n_observations=64, left_shape=(8, 20), right_shape=(8, 20),
                device='cpu')
        else:
            m = TMCA(left, right, device='cpu')
        m.set_solver(truncate=6, batch_size=3, mesh=mesh)
        m.normalize()
        m.solve(complexify=True)
        m.rotate(4)
        models.append(m)
    return models


def _boot_runs(models):
    mem, backed = models
    kw = dict(n_modes=3, block_size=2, seed=21)
    return {'mem_iter': mem.bootstrapping(4, strategy='iterative', **kw),
            'time': backed.bootstrapping(4, **kw),
            'time_iter': backed.bootstrapping(4, strategy='iterative', **kw),
            'space': backed.bootstrapping(4, axis=1, on_right=True, **kw),
            'space_right': backed.bootstrapping(
                4, axis=1, on_left=False, on_right=True, **kw)}


def _case_boot_streamed(mesh):
    return _boot_runs(_boot_models(mesh))


def _dry_flow(mesh, folder):
    """``dryrun_multichip``'s public flow on ``mesh`` (None: unsharded);
    the save goes to ``folder`` (written by rank 0 on a mesh)."""
    arrays, coords = _dry_fields()
    n_obs, n_lat, n_lon = DRY
    n_rot, n_runs = 6, 4
    out = {}
    m = TxMCA(*_dry_da(arrays, coords), device='cpu')
    m.set_solver(truncate=n_rot, mesh=mesh, spectrum='fast',
                 subspace_iters=6)
    m.solve(complexify=True)
    m.rotate(n_rot)
    out['surr'] = _np(m.rule_n(n_runs, seed=7, disable_progress=True))
    out['var'] = _np(m.variance())
    out['eofs'] = {k: _np(v) for k, v in m.eofs(4).items()}
    out['pcs'] = {k: _np(v) for k, v in m.pcs(4).items()}
    out['boot'] = _np(m.bootstrapping(n_runs=2, n_modes=2, block_size=8,
                                      seed=43, disable_progress=True))
    m.rotate(n_rot, power=4)
    out['surr_pm'] = _np(m.rule_n(2, seed=11, disable_progress=True))
    m.save_analysis(path=folder)
    loaded = TxMCA(device='cpu')
    loaded.load_analysis(os.path.join(folder, 'info.xmca'))
    out['sv'] = _np(m.singular_values())
    out['sv_loaded'] = _np(loaded.singular_values())
    out['eofs3'] = _np(m.eofs(3)['left'])
    out['eofs3_loaded'] = _np(loaded.eofs(3)['left'])
    X = arrays[0].reshape(n_obs, n_lat * n_lon)
    mc = TMCA.from_chunks(_wide_loader(X, 555), None, n_observations=n_obs,
                          left_shape=(n_lat, n_lon), device='cpu')
    mc.set_solver(truncate=n_rot, mesh=mesh)
    mc.solve()
    out['sv_stream'] = _np(mc.singular_values())
    out['boot_stream'] = _np(mc.bootstrapping(
        2, n_modes=2, block_size=8, seed=17, disable_progress=True))
    return out


def _rank_main(rank, port, inputs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method='tcp://localhost:%d' % port,
                            world_size=WORLD, rank=rank,
                            timeout=timedelta(seconds=TIMEOUT_S))
    with open(inputs, 'rb') as f:
        inp = pickle.load(f)
    meshes = {name: make_mesh(*shape, device_type='cpu')
              for name, shape in MESHES.items()}
    try:
        make_mesh(64, 64, device_type='cpu')
        too_many = 'no error'
    except ValueError as err:
        too_many = str(err)
    folder = os.path.join(out_dir, 'saved')
    out = {
        'too_many': too_many,
        'solve': _case_solve(meshes['space']),
        'rule_n': _case_rule_n(meshes['ensemble']),
        'bootstrap': _case_bootstrap(meshes['ensemble']),
        'boot_state': _case_boot_state(meshes['both'], inp['state'],
                                       BOOT_STATE),
        'boot_state_space': _case_boot_state(
            meshes['space'], inp['state'],
            [k for k in BOOT_STATE if k not in ('standard', 'iterative')]),
        'boot_axis': {name: _boot_axis_runs(meshes[name])
                      for name in ('space', 'both')},
        '2d': _case_2d(meshes['both']),
        'fast_trunc': _case_fast_trunc(meshes['space'], inp['omega3']),
        'fast_rot': _case_fast_rot(meshes['both'], inp['omega4']),
        'fast_rot_analytic': _case_fast_rot_analytic(meshes['space'],
                                                     inp['omega5']),
        'streamed': _case_streamed(meshes['space']),
        'fold_api': _case_fold_api(meshes['space']),
        'stream_api': _case_stream_api(meshes['space']),
        'extend': _case_extend(meshes['space']),
        'boot_streamed': _case_boot_streamed(meshes['both']),
        'dryrun': _dry_flow(meshes['both'], folder),
        'collectives': tmesh.collective_counts(),
    }
    with open(os.path.join(out_dir, 'rank%d.pkl' % rank), 'wb') as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@contextlib.contextmanager
def _one_thread():
    """The ranks' threading (one thread each), so an unsharded reference
    computed here sums in the same order as on a rank."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


# ------------------------------------------------------------- fixtures
def _jax_omega(seed, n, k):
    """The start block JAX's subspace_svd draws from ``PRNGKey(seed)``."""
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (n, min(k + 16, n)), jnp.float64))


def _jax_state():
    from xmca_tpu.array import MCA as JMCA
    from xmca_tpu_torch.utils.state import to_state
    jm = JMCA(*_grid(seeds=(10, 11)))
    jm.normalize()
    jm.solve(complexify=True)
    jm.rotate(3, power=2)
    return jm, to_state(jm)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The 4-rank job's per-rank results (and the JAX model whose state
    it carried)."""
    folder = tmp_path_factory.mktemp('mesh_job')
    jm, state = _jax_state()
    inputs = folder / 'inputs.pkl'
    with open(inputs, 'wb') as f:
        pickle.dump({'state': state, 'omega3': _jax_omega(3, 512, 10),
                     'omega4': _jax_omega(4, 512, 8),
                     'omega5': _jax_omega(5, 512, 8)}, f)
    torch.multiprocessing.start_processes(
        _rank_main, args=(_free_port(), str(inputs), str(folder)),
        nprocs=WORLD, join=True, start_method='spawn')
    out = []
    for r in range(WORLD):
        with open(folder / ('rank%d.pkl' % r), 'rb') as f:
            out.append(pickle.load(f))
    return {'ranks': out, 'jax_model': jm}


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                ('ensemble', 'space'))


def _abs_close(a, b, atol):
    np.testing.assert_allclose(np.abs(a), np.abs(b), atol=atol)


def _same_on_every_rank(ranks, case, key=None):
    first = ranks[0][case] if key is None else ranks[0][case][key]
    for r in ranks[1:]:
        other = r[case] if key is None else r[case][key]
        np.testing.assert_array_equal(np.asarray(other), np.asarray(first))
    return np.asarray(first)


# ------------------------------------------------- test_mesh.py's cases
def test_space_sharded_solve_matches_single_device(ranks):
    """sharded_solve on (1, 4) against JAX's on the same mesh shape
    (1e-10 on the spectrum, 1e-8 on |V|)."""
    import jax.numpy as jnp
    from xmca_tpu.parallel import sharded_solve
    Xl, Xr = _xy()
    s_j, Vl_j, Vr_j = sharded_solve(jnp.asarray(Xl), jnp.asarray(Xr),
                                    mesh=_jax_mesh(MESHES['space']))
    rk = ranks['ranks']
    s = _same_on_every_rank(rk, 'solve', 's')
    np.testing.assert_allclose(s, np.asarray(s_j), atol=1e-10)
    _abs_close(np.concatenate([r['solve']['Vl'] for r in rk]),
               np.asarray(Vl_j), 1e-8)
    _abs_close(np.concatenate([r['solve']['Vr'] for r in rk]),
               np.asarray(Vr_j), 1e-8)


def test_distribute_array_sharding(ranks):
    import jax.numpy as jnp
    from xmca_tpu.parallel import distribute_array as jdistribute
    xs = jdistribute(jnp.asarray(_xy()[0]), _jax_mesh(MESHES['space']))
    jax_shapes = {s.data.shape for s in xs.addressable_shards}
    assert jax_shapes == {(96, 16)}
    assert {r['solve']['shard'] for r in ranks['ranks']} == jax_shapes


def test_ensemble_sharded_rule_n_matches_unsharded(ranks):
    """Sharded == unsharded Rule-N, exactly in the port (the +-1 and the
    'normal16' surrogates), to 1e-9 in JAX (each on (4, 1))."""
    from xmca_tpu.array import MCA as JMCA
    for r in ranks['ranks']:
        for got in r['rule_n'].values():
            np.testing.assert_array_equal(got['sharded'], got['plain'])
            assert got['plain'].shape[1] >= 7
    jm = JMCA(*_grid())
    jm.solve()
    plain = np.asarray(jm.rule_n(8, seed=99))
    jm.set_solver(mesh=_jax_mesh(MESHES['ensemble']))
    np.testing.assert_allclose(np.asarray(jm.rule_n(8, seed=99)), plain,
                               rtol=1e-9)


def test_ensemble_sharded_bootstrap_matches_unsharded(ranks):
    from xmca_tpu.array import MCA as JMCA
    for r in ranks['ranks']:
        np.testing.assert_array_equal(r['bootstrap']['sharded'],
                                      r['bootstrap']['plain'])
    jm = JMCA(*_grid())
    jm.solve()
    plain = np.asarray(jm.bootstrapping(8, 3, disable_progress=True,
                                        seed=5))
    jm.set_solver(mesh=_jax_mesh(MESHES['ensemble']))
    np.testing.assert_allclose(
        np.asarray(jm.bootstrapping(8, 3, disable_progress=True, seed=5)),
        plain, rtol=1e-9)


_STATE_CASES = (['standard', 'iterative']
                + ['{}-{}'.format(k, mesh) for k in BOOT_STATE
                   if k not in ('standard', 'iterative')
                   for mesh in ('both', 'space')])


@pytest.mark.parametrize('case', _STATE_CASES)
def test_mesh_bootstrap_of_carried_state_matches_jax(ranks, case):
    """A JAX solution (complexified, promax) carried into port models on
    (2, 2) and (1, 4): the bootstrap with one block spanning the
    resampled axis and the exact spectrum equals JAX's on the same mesh
    shape (1e-7, the unsharded port's tolerance against JAX): the time
    axis ('standard', 'iterative'), the column axis of the space-sharded
    model (the left field, the right, both; 'iterative' with both), and
    the runs split over the space axis itself."""
    name, _, mesh = case.partition('-')
    mesh = mesh or 'both'
    ens, kw = _boot_state_kw(name)
    jm = ranks['jax_model']
    jm.set_solver(mesh=_jax_mesh(MESHES[mesh]), ensemble_axis=ens,
                  spectrum='exact', ensemble_tol=1e-8)
    ref = np.asarray(jm.bootstrapping(3, **kw))
    key = 'boot_state' if mesh == 'both' else 'boot_state_space'
    got = _same_on_every_rank(ranks['ranks'], key, name)
    assert (ref != 0).any()
    np.testing.assert_allclose(got, ref, rtol=1e-7)


_UNSHARDED = {}                 # the unsharded port's BOOT_AXIS runs


@pytest.mark.parametrize('mesh', ['space', 'both'])
@pytest.mark.parametrize('run', list(BOOT_AXIS))
def test_mesh_bootstrap_axis1_and_space_split_match_unsharded(ranks, run,
                                                              mesh):
    """On (1, 4) and (2, 2), a space-sharded model's column resamples
    (each rank its draws on its own columns: the left field, the right,
    both, blocks of 1-8, without replacement, iterative, extended) and
    its runs split over the space axis (standard, iterative, a column
    resample) against the unsharded port run for run (1e-8: f64 roundoff
    of a changed summation order through the rotations)."""
    if not _UNSHARDED:
        with _one_thread():
            _UNSHARDED.update(_boot_axis_runs(None))
    ref = _UNSHARDED[run]
    got = _same_on_every_rank([r['boot_axis'] for r in ranks['ranks']],
                              mesh, run)
    assert (ref != 0).any()
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-12)


def test_mesh_2d_ensemble_and_space(ranks):
    from xmca_tpu.stats.significance import rule_n_spectra
    spectra, totals = rule_n_spectra(
        64, (32, 24), 4, dtype=np.float64, mesh=_jax_mesh(MESHES['both']),
        seed=0, batch_size=4)
    assert spectra.shape[0] == 4 and totals.shape == (4,)
    assert np.isfinite(spectra).all()
    for r in ranks['ranks']:
        sh, tot, _ = r['2d']['sharded']
        plain, tot_plain, _ = r['2d']['plain']
        assert sh.shape[0] == 4 and tot.shape == (4,)
        assert np.isfinite(sh).all()
        np.testing.assert_array_equal(sh, plain)
        np.testing.assert_array_equal(tot, tot_plain)


def test_make_mesh_too_many_devices(ranks):
    """JAX's ``ValueError`` and its words, with the port's world of 4."""
    import jax
    from xmca_tpu.parallel import make_mesh as jmake
    with pytest.raises(ValueError) as ref:
        jmake(ensemble=64, space=64)
    assert str(ref.value) == ('mesh needs 4096 devices but only {} are '
                              'available'.format(len(jax.devices())))
    for r in ranks['ranks']:
        assert r['too_many'] == ('mesh needs 4096 devices but only 4 are '
                                 'available')


def test_space_sharded_fast_solve_truncated(ranks):
    """The truncated fast solve on (1, 4) from JAX's start block against
    JAX's on the same mesh shape: spectrum 1e-10, leading 8 modes
    sign-aligned 1e-7."""
    import jax
    import jax.numpy as jnp
    from tests.conftest import align_modes
    from xmca_tpu.core.fastpath import fast_solve_truncated
    from xmca_tpu.parallel import distribute_array as jdistribute
    mesh = _jax_mesh(MESHES['space'])
    Xl, Xr = (jdistribute(jnp.asarray(x), mesh) for x in _big_xy())
    s, Vl, Vr = fast_solve_truncated(Xl, Xr, jax.random.PRNGKey(3),
                                     n_modes=10, n_iter=10)
    rk = ranks['ranks']
    np.testing.assert_allclose(_same_on_every_rank(rk, 'fast_trunc', 's'),
                               np.asarray(s), rtol=1e-10)
    assert len({r['fast_trunc']['Vl'].shape for r in rk}) == 1
    for key, ref in (('Vl', Vl), ('Vr', Vr)):
        ours = np.concatenate([r['fast_trunc'][key] for r in rk])[:, :8]
        ref = np.asarray(ref)[:, :8]
        np.testing.assert_allclose(align_modes(ours, ref), ref, atol=1e-7)


def test_space_sharded_fast_rotated_variance(ranks):
    import jax
    import jax.numpy as jnp
    from xmca_tpu.core.fastpath import fast_rotated_variance
    from xmca_tpu.parallel import distribute_array as jdistribute
    mesh = _jax_mesh(MESHES['both'])
    Xl, Xr = (jdistribute(jnp.asarray(x), mesh) for x in _big_xy())
    var, conv = fast_rotated_variance(Xl, Xr, jax.random.PRNGKey(4),
                                      n_rot=8, power=1, n_iter=10)
    for r in ranks['ranks']:
        assert bool(conv) and r['fast_rot']['conv']
        np.testing.assert_allclose(r['fast_rot']['var'], np.asarray(var),
                                   rtol=1e-9)


def test_space_sharded_analytic_rotated_variance(ranks):
    import jax
    import jax.numpy as jnp
    from xmca_tpu.core.fastpath import (fast_rotated_variance_analytic,
                                        hilbert_imag_matrix)
    from xmca_tpu.parallel import distribute_array as jdistribute
    mesh = _jax_mesh(MESHES['space'])
    Xl, Xr = (jdistribute(jnp.asarray(x), mesh) for x in _big_xy())
    H = jnp.asarray(hilbert_imag_matrix(512, np.float64))
    var, conv = fast_rotated_variance_analytic(
        Xl, Xr, H, jax.random.PRNGKey(5), n_rot=8, n_iter=10, tol=1e-5)
    for r in ranks['ranks']:
        assert bool(conv) and r['fast_rot_analytic']['conv']
        np.testing.assert_allclose(r['fast_rot_analytic']['var'],
                                   np.asarray(var), rtol=1e-9)


@pytest.mark.parametrize('complexify', [False, True])
def test_space_sharded_streamed_solve_matches_unsharded(ranks, complexify):
    """A streamed solve with 13-column chunks on (1, 4) (every chunk
    split unevenly, NaN columns) against the port's unsharded one over
    64/48-column chunks (the start blocks of the two packages differ):
    spectrum and total 1e-9, masks equal, means 1e-12, |V| and |scores|
    1e-8; JAX's sharded against its unsharded as its test holds them."""
    import jax.numpy as jnp
    from xmca_tpu.core.streaming import chunks_from_array, streamed_mca
    Xl, Xr = _stream_xy()
    with _one_thread():
        base = tstream.streamed_mca(_loader(Xl, 64), _loader(Xr, 48), 96, 5,
                                    complexify=complexify)
    for r in ranks['ranks']:
        sh = r['streamed'][complexify]
        np.testing.assert_allclose(sh['svals'], base.svals, rtol=1e-9)
        assert sh['total'] == pytest.approx(base.total_covariance,
                                            rel=1e-9)
        for k in ('left', 'right'):
            assert (sh['keep'][k] == base.keep[k]).all()
            np.testing.assert_allclose(sh['means'][k], base.means[k],
                                       atol=1e-12)
        _abs_close(sh['V_left'], base.V_left.numpy(), 1e-8)
        _abs_close(sh['V_right'], base.V_right.numpy(), 1e-8)
        _abs_close(sh['scores_left'], base.scores_left.numpy(), 1e-8)
    jbase = streamed_mca(lambda: chunks_from_array(Xl, 64),
                         lambda: chunks_from_array(Xr, 48), 96, 5,
                         complexify=complexify, dtype=jnp.float64)
    jsh = streamed_mca(lambda: chunks_from_array(Xl, 13),
                       lambda: chunks_from_array(Xr, 13), 96, 5,
                       complexify=complexify, dtype=jnp.float64,
                       mesh=_jax_mesh(MESHES['space']))
    np.testing.assert_allclose(jsh.svals, jbase.svals, rtol=1e-9)
    # the two packages' spectra from different start blocks
    np.testing.assert_allclose(
        ranks['ranks'][0]['streamed'][complexify]['svals'], jsh.svals,
        rtol=1e-9)


def test_space_sharded_fold_solve_public_api(ranks):
    """The complexified truncated solve + rotate on (1, 4) against the
    unsharded port (spectrum 1e-7, variance 1e-5) and against JAX's on
    the same mesh shape at the same tolerances."""
    from xmca_tpu.array import MCA as JMCA
    with _one_thread():
        mb = _fold_model(None)
    left, right = _grid(48, 8, 16, seeds=(3, 4))
    jm = JMCA(left, right)
    jm.set_solver(truncate=5, mesh=_jax_mesh(MESHES['space']))
    jm.solve(complexify=True)
    jm.rotate(4)
    for r in ranks['ranks']:
        got = r['fold_api']
        for ref_s, ref_v in ((mb.singular_values(5), mb.variance(4)),
                             (jm.singular_values(5), jm.variance(4))):
            np.testing.assert_allclose(got['s'], np.asarray(ref_s),
                                       rtol=1e-7)
            np.testing.assert_allclose(got['var'], np.asarray(ref_v),
                                       rtol=1e-5)


def test_space_sharded_streamed_public_api(ranks):
    """from_chunks + a (1, 4) mesh against the unsharded port (1e-9 on
    the spectrum, 1e-8 on |EOFs|); JAX's on the same mesh shape against
    its unsharded one (1e-9), and the two packages' sharded spectra, from
    different start blocks, to 1e-6."""
    from xmca_tpu.array import MCA as JMCA
    with _one_thread():
        mb = _stream_api_model(None)
    rng = np.random.default_rng(7)
    X = {k: rng.standard_normal((64, 30 * 11)) for k in ('l', 'r')}
    jm = JMCA.from_chunks(_wide_loader(X['l'], 37), _wide_loader(X['r'], 37),
                          n_observations=64, left_shape=(30, 11),
                          right_shape=(30, 11))
    jm.set_solver(truncate=4)
    jm.solve()
    j_plain = np.asarray(jm.singular_values())
    jm.set_solver(mesh=_jax_mesh(MESHES['space']))
    jm.solve()
    j_sharded = np.asarray(jm.singular_values())
    np.testing.assert_allclose(j_sharded, j_plain, rtol=1e-9)
    eb = mb.eofs(4, rotated=False)
    for r in ranks['ranks']:
        got = r['stream_api']
        np.testing.assert_allclose(got['s'], mb.singular_values(),
                                   rtol=1e-9)
        np.testing.assert_allclose(got['s'], j_sharded, rtol=1e-6)
        for k in ('left', 'right'):
            _abs_close(got['eofs'][k], eb[k], 1e-8)


# ------------------------------------------ what test_mesh.py leaves out
@pytest.mark.parametrize('extend', ['exp', 'theta'])
def test_space_sharded_extension(ranks, extend):
    """Boundary extension is column by column: the extended dense solve
    and rotation on (1, 4) equal the unsharded port to 1e-9 (|EOFs|,
    |PCs| 1e-8)."""
    from tests.conftest import align_modes
    with _one_thread():
        mb = _extend_model(None, extend)
    for r in ranks['ranks']:
        got = r['extend'][extend]
        np.testing.assert_allclose(got['s'], mb.singular_values(6),
                                   rtol=1e-9)
        np.testing.assert_allclose(got['var'], mb.variance(3), rtol=1e-9)
        for k in ('left', 'right'):
            for name, ref in (('eofs', mb.eofs(3)[k]), ('pcs', mb.pcs(3)[k])):
                np.testing.assert_allclose(align_modes(got[name][k], ref),
                                           ref, atol=1e-8)


@pytest.mark.parametrize('run', ['mem_iter', 'time', 'time_iter', 'space',
                                 'space_right'])
def test_mesh_bootstrap_matches_unsharded(ranks, run):
    """On (2, 2): the iterative in-memory bootstrap, and the chunk-backed
    bootstrap on the time axis (standard, iterative) and on the space axis
    (both fields, the right one), rotated and normalized with a NaN
    column, against the unsharded port run for run (1e-8: f64 roundoff of
    a changed summation order through the rotations)."""
    with _one_thread():
        ref = _boot_runs(_boot_models(None))[run]
    got = _same_on_every_rank(ranks['ranks'], 'boot_streamed', run)
    assert (ref != 0).any()
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-12)


def test_dryrun_multichip_flow(ranks, tmp_path):
    """``dryrun_multichip``'s flow on (2, 2) at 256 x 32 x 128 against the
    unsharded port, with its thresholds: rotated variance, aligned EOFs
    and PCs 1e-5, bootstrap 1e-4 with equal convergence masks, save ->
    load 1e-5 / 1e-4, streamed == resident 1e-5, streamed bootstrap ==
    resident 1e-3; and the unsharded rotated variance against JAX's
    (1e-5)."""
    from xmca_tpu.compat import xr as jxr
    from xmca_tpu.xarray import xMCA as JxMCA

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def rel_aligned(a, b):
        a = np.asarray(a).reshape(-1, np.shape(a)[-1])
        b = np.asarray(b).reshape(-1, np.shape(b)[-1])
        err = 0.0
        for j in range(a.shape[1]):
            ph = np.vdot(a[:, j], b[:, j])
            ph = ph / max(abs(ph), 1e-30)
            err = max(err, float(np.abs(b[:, j] - ph * a[:, j]).max()
                                 / max(np.abs(b[:, j]).max(), 1e-30)))
        return err

    with _one_thread():
        ref = _dry_flow(None, str(tmp_path))
    got = ranks['ranks'][0]['dryrun']
    for r in ranks['ranks'][1:]:
        np.testing.assert_array_equal(r['dryrun']['var'], got['var'])
    assert np.isfinite(got['var']).all() and np.isfinite(got['surr']).all()
    assert got['surr'].shape[0] == 6 and got['surr'].shape[1] >= 3
    # the same runs, rescaled by two models' totals
    assert rel(got['surr'], ref['surr']) < 1e-9
    assert rel(got['var'], ref['var']) < 1e-5
    for k in ('left', 'right'):
        assert rel_aligned(got['eofs'][k], ref['eofs'][k]) < 1e-5
        assert rel_aligned(got['pcs'][k], ref['pcs'][k]) < 1e-5
    assert got['boot'].shape == (2, 2)
    assert ((got['boot'] == 0) == (ref['boot'] == 0)).all()
    assert (ref['boot'] != 0).any() and rel(got['boot'], ref['boot']) < 1e-4
    assert got['surr_pm'].shape[0] == 6 and np.isfinite(got['surr_pm']).all()
    assert rel(got['sv_loaded'], got['sv']) < 1e-5
    assert rel(got['eofs3_loaded'], got['eofs3']) < 1e-4
    assert rel(got['sv_stream'][:4], ref['sv_stream'][:4]) < 1e-5
    assert rel(got['boot_stream'], ref['boot_stream']) < 1e-3
    arrays, coords = _dry_fields()
    jm = JxMCA(*[jxr.DataArray(a, dims=('time', 'lat', 'lon'),
                               coords=coords) for a in arrays])
    jm.set_solver(truncate=6, spectrum='fast', subspace_iters=6)
    jm.solve(complexify=True)
    jm.rotate(6)
    assert rel(ref['var'], _np(jm.variance())) < 1e-5


def test_collectives_are_counted(ranks):
    for r in ranks['ranks']:
        counts = r['collectives']
        assert counts['all_reduce'] > 0 and counts['bytes'] > 0


# ------------------------------------------- a world of one, in process
@pytest.fixture(scope='module')
def world_of_one():
    if dist.is_initialized():
        pytest.fail('a process group is already initialized')
    dist.init_process_group('gloo',
                            init_method='tcp://localhost:%d' % _free_port(),
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=TIMEOUT_S))
    yield make_mesh(1, 1, device_type='cpu')
    dist.destroy_process_group()


def test_make_mesh_checks_the_world(world_of_one):
    with pytest.raises(ValueError, match='mesh needs 4 devices but only 1 '
                                         'are available'):
        make_mesh(2, 2, device_type='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='needs a CUDA device'):
            make_mesh(1, 1)
    assert tmesh.axis_size(world_of_one, 'space') == 1
    m = TMCA(*_grid(), device='cpu')
    m.solve()
    m.set_solver(mesh=world_of_one, ensemble_axis='runs')
    with pytest.raises(ValueError, match="'runs' is not an axis"):
        m.rule_n(2, seed=1)


def test_distribute_array_shards_and_refuses_uneven(world_of_one):
    x = np.arange(40.0).reshape(4, 10)
    np.testing.assert_array_equal(distribute_array(x, world_of_one), x)
    assert distribute_array(_t(x), world_of_one, axis=0).shape == (4, 10)
    with pytest.raises(ValueError, match='mesh is required'):
        tmesh.sharded_solve(x)


def test_world_of_one_equals_no_mesh(world_of_one):
    """A (1, 1) mesh runs the unsharded arithmetic: the dryrun flow's
    results are equal bit for bit, with no collective."""
    tmesh.reset_collective_counts()
    m = _fold_model(world_of_one)
    mb = _fold_model(None)
    np.testing.assert_array_equal(m.singular_values(), mb.singular_values())
    np.testing.assert_array_equal(m.variance(), mb.variance())
    np.testing.assert_array_equal(m.eofs(4)['left'], mb.eofs(4)['left'])
    np.testing.assert_array_equal(_np(m.rule_n(4, seed=3)),
                                  _np(mb.rule_n(4, seed=3)))
    np.testing.assert_array_equal(m.bootstrapping(2, 2, seed=3),
                                  mb.bootstrapping(2, 2, seed=3))
    assert tmesh.collective_counts() == {}


def test_uneven_space_shards_raise(world_of_one):
    """The JAX package's placement of a width-10 array over 4 shards
    raises ``ValueError``; so does the port's."""
    from xmca_tpu.parallel import distribute_array as jdistribute
    import jax.numpy as jnp
    with pytest.raises(ValueError):
        jdistribute(jnp.zeros((4, 10)), _jax_mesh(MESHES['space']))
    with pytest.raises(ValueError, match='does not divide'):
        distribute_array(np.zeros((4, 10)), _FakeSpace(4))


class _FakeSpace:
    """A stand-in mesh of ``space`` shards for the width checks, which
    read only its axis sizes (rank 0)."""

    mesh_dim_names = ('ensemble', 'space')

    def __init__(self, space):
        self._space = space

    def size(self, dim=None):
        return (1, self._space)[dim]

    def get_local_rank(self, axis):
        return 0


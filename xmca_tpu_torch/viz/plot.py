"""Host-side matplotlib figures of MCA results.

The port's own copy of ``xmca_tpu/viz/plot.py`` (the port imports
nothing of the JAX package): per-mode figures with a PC column, an
EOF/Amplitude map column, and, for complex solutions, a Phase column, with
shared colorbars, threshold masking, and cartopy map projections in the
labeled-array variant.  Data extraction (:func:`_mode_content`), grid
placement (:func:`_plan_grid`) and rendering (:class:`_MapCanvas`,
:func:`_draw_series`) are independent stages, so the imshow and cartopy
variants share everything but the canvas.  The getters run on the
model's device; only their host results are drawn.

Cartopy is optional: when it is importable the map panels are real
``GeoAxes`` with coastlines/land features; otherwise the same fields are
drawn on plain axes in data coordinates.  matplotlib is imported inside
the functions.
"""
import numpy as np

from xmca_tpu_torch.utils.text import boldify_str


# --------------------------------------------------------------- content

def _bold(text):
    return boldify_str(str(text).replace('_', ' '))


def _mode_content(model, mode, threshold, phase_shift):
    """Everything a mode figure shows, as plain arrays keyed by field.

    Complex solutions display amplitude + phase; real ones the raw EOF.
    Threshold masking hides map cells whose (amplitude) magnitude falls
    below ``threshold`` — phase panels inherit the same mask so the two
    map columns stay consistent (reference semantics).
    """
    is_complex = model._analysis['is_complex']
    content = {
        'series': model.pcs(mode, scaling='max', phase_shift=phase_shift),
        'phase': model.spatial_phase(mode, phase_shift=phase_shift),
        'explained': float(
            np.ravel(np.asarray(model.explained_variance(mode)))[-1]
        ),
        'is_complex': is_complex,
        'map_kind': 'Amplitude' if is_complex else 'EOF',
        'map_range': (0, 1) if is_complex else (-1, 1),
    }
    if is_complex:
        content['maps'] = model.spatial_amplitude(mode, scaling='max')
    else:
        content['maps'] = model.eofs(mode, scaling='max')

    for key in content['series']:
        content['series'][key] = _last_mode(content['series'][key]).real
        field = _last_mode(content['maps'][key])
        phase = _last_mode(content['phase'][key])
        visible = np.abs(field) >= threshold
        content['maps'][key] = np.where(visible, field, np.nan)
        content['phase'][key] = np.where(visible, phase, np.nan)
    return content


def _last_mode(arr):
    """Slice the trailing mode axis of an (ndarray or DataArray) result."""
    return np.asarray(arr)[..., -1]


_CMAP_DEFAULTS = {
    'EOF': 'RdBu_r',
    'Amplitude': 'Blues',
    'Phase': 'twilight',
}
_PHASE_TICKS = ([-np.pi, 0, np.pi], [r'-$\pi$', '0', r'$\pi$'])


# ---------------------------------------------------------------- layout

def _plan_grid(n_fields, with_phase, orientation='horizontal'):
    """Grid-cell assignment for every panel of the figure.

    Returns (n_rows, n_cols, height_ratios, width_ratios, cells) where
    ``cells`` maps (column_kind, field_index_or_'cbar') -> (row, col).
    Column kinds: 'series', 'map', 'phase'.
    """
    kinds = ['series', 'map'] + (['phase'] if with_phase else [])
    if orientation == 'horizontal':
        n_rows, n_cols = n_fields + 1, len(kinds)
        heights = [1.0] * n_fields + [0.05]
        widths = [1.0] * n_cols
        cells = {}
        for col, kind in enumerate(kinds):
            for i in range(n_fields):
                cells[kind, i] = (i, col)
            if kind != 'series':
                cells[kind, 'cbar'] = (n_fields, col)
        return n_rows, n_cols, heights, widths, cells
    if orientation == 'vertical':
        # maps stacked in rows, colorbars in a slim leading column,
        # PC panels in the bottom row (reference vertical layout)
        n_rows, n_cols = len(kinds), n_fields + 1
        heights = [1.0] * n_rows
        widths = [0.05] + [1.0] * n_fields
        cells = {}
        row_of = {'map': 0, 'phase': 1, 'series': len(kinds) - 1}
        for kind in kinds:
            row = row_of[kind]
            for i in range(n_fields):
                cells[kind, i] = (row, i + 1)
            if kind != 'series':
                cells[kind, 'cbar'] = (row, 0)
        return n_rows, n_cols, heights, widths, cells
    raise ValueError("orientation must be 'horizontal' or 'vertical'")


# --------------------------------------------------------------- drawing

def _draw_series(ax, values, label):
    ax.plot(np.arange(len(values)), values)
    ax.set_ylim(-1.2, 1.2)
    ax.set_yticks([-1, 0, 1])
    ax.set_ylabel(label, fontweight='bold')
    ax.set_xlabel('')
    ax.set_title('')
    for side in ('right', 'top'):
        ax.spines[side].set_visible(False)


def _lonlat_extent(lon, lat, central_longitude=0):
    """[east, west, south, north] with longitudes wrapped to -180..179.

    Behavior of the reference's extent helper
    (xmca/tools/xarray.py:34-69).
    """
    wrapped = np.sort(((np.asarray(lon) + 180) % 360) - 180)
    return [
        float(wrapped.min()) + central_longitude + 0.001,
        float(wrapped.max()) + central_longitude - 0.001,
        float(np.min(lat)), float(np.max(lat)),
    ]


class _MapCanvas:
    """Map-panel factory: cartopy GeoAxes when available, plain otherwise.

    Centralizes every cartopy touchpoint so the rest of the module is
    projection-agnostic.
    """

    def __init__(self, projections=None, resolution='110m', land=True):
        try:
            import cartopy.crs as _ccrs
            import cartopy.feature as _cfeature
        except ImportError:
            _ccrs = _cfeature = None
        self._ccrs = _ccrs
        self._cfeature = _cfeature
        self.resolution = resolution
        self.land = land
        self._projections = projections or {}

    @property
    def active(self):
        return self._ccrs is not None

    def projection_for(self, key):
        if not self.active:
            return None
        default = self._ccrs.PlateCarree()
        spec = self._projections
        try:
            return spec.get(key, default)
        except AttributeError:
            # a single projection object applies to all fields
            return spec if spec is not None else default

    def data_crs(self):
        return self._ccrs.PlateCarree() if self.active else None

    def add_axes(self, fig, gridspec_cell, key):
        proj = self.projection_for(key)
        if proj is None:
            return fig.add_subplot(gridspec_cell)
        return fig.add_subplot(gridspec_cell, projection=proj)

    def paint(self, ax, key, lon, lat, values, cmap, vmin, vmax):
        extra = {}
        if self.active:
            extra['transform'] = self.data_crs()
        mesh = ax.pcolormesh(
            lon, lat, values, cmap=cmap, vmin=vmin, vmax=vmax, **extra
        )
        if self.active:
            lon0 = self.projection_for(key).proj4_params.get('lon_0', 0)
            ax.set_extent(
                _lonlat_extent(lon, lat, lon0), crs=self.data_crs()
            )
            if self.resolution in ('110m', '50m', '10m'):
                ax.coastlines(lw=.4, resolution=self.resolution)
            if self.land:
                ax.add_feature(
                    self._cfeature.LAND, color='#808080', zorder=0
                )
        ax.set_title('')
        ax.set_aspect('auto')
        return mesh


# ------------------------------------------------------- ndarray variant

def plot_mca_mode(model, mode, threshold=0, phase_shift=0, cmap_eof=None,
                  cmap_phase=None, figsize=(8.3, 5.0)):
    """imshow-panel figure of `mode` for the ndarray API.

    Visual contract of reference ``MCA.plot`` (xmca/array.py:1430-1574).
    """
    import matplotlib.pyplot as plt

    content = _mode_content(model, mode, threshold, phase_shift)
    field_keys = list(content['series'])
    names = [_bold(model._field_names[k]) for k in field_keys]
    kind = content['map_kind']
    vmin, vmax = content['map_range']
    cmaps = {
        'map': cmap_eof or _CMAP_DEFAULTS[kind],
        'phase': cmap_phase or _CMAP_DEFAULTS['Phase'],
    }

    n_rows, n_cols, heights, _, cells = _plan_grid(
        len(field_keys), content['is_complex'], 'horizontal'
    )
    fig = plt.figure(figsize=figsize, dpi=150)
    fig.subplots_adjust(hspace=0.1, wspace=.1, left=0.25)
    gs = fig.add_gridspec(n_rows, n_cols, height_ratios=heights)

    def _as_image(arr):
        return arr if arr.ndim == 2 else arr[np.newaxis, :]

    series_axes = []
    for i, key in enumerate(field_keys):
        ax = fig.add_subplot(gs[cells['series', i]])
        _draw_series(ax, content['series'][key], names[i])
        series_axes.append(ax)

        ax = fig.add_subplot(gs[cells['map', i]])
        mesh = ax.imshow(
            _as_image(content['maps'][key]).real, origin='lower',
            vmin=vmin, vmax=vmax, cmap=cmaps['map'],
        )
        ax.set_aspect('auto')
        ax.xaxis.set_visible(False)
        ax.yaxis.set_visible(False)
        if i == 0:
            ax.set_title(_bold(kind), fontweight='bold')

        if content['is_complex']:
            ax = fig.add_subplot(gs[cells['phase', i]])
            phase_mesh = ax.imshow(
                _as_image(content['phase'][key]), origin='lower',
                vmin=-np.pi, vmax=np.pi, cmap=cmaps['phase'],
            )
            ax.set_aspect('auto')
            ax.xaxis.set_visible(False)
            ax.yaxis.set_visible(False)
            if i == 0:
                ax.set_title(_bold('Phase'), fontweight='bold')

    cax = fig.add_subplot(gs[cells['map', 'cbar']])
    plt.colorbar(mesh, cax=cax, orientation='horizontal')
    cax.xaxis.set_ticks([vmin, vmax] if content['is_complex']
                        else [vmin, 0, vmax])
    if content['is_complex']:
        cax = fig.add_subplot(gs[cells['phase', 'cbar']])
        plt.colorbar(phase_mesh, cax=cax, orientation='horizontal')
        cax.xaxis.set_ticks([-3.14, 0, 3.14])
        cax.set_xticklabels(_PHASE_TICKS[1])

    title = r'PC {:d} ({:.1f} %)'.format(mode, content['explained'])
    series_axes[0].set_title(_bold(title), fontweight='bold')
    series_axes[0].xaxis.set_visible(False)
    if len(series_axes) == 2:
        series_axes[0].spines['bottom'].set_visible(False)


# -------------------------------------------------- labeled-array variant

def _panel_grid_coords(da):
    """(values, lon, lat) of a 2-D labeled map panel."""
    values = np.asarray(da)
    coords = getattr(da, 'coords', {})
    lon = (np.asarray(coords['lon']) if 'lon' in coords
           else np.arange(values.shape[-1]))
    lat = (np.asarray(coords['lat']) if 'lat' in coords
           else np.arange(values.shape[0]))
    return values, lon, lat


def plot_xmca_mode(model, mode, threshold=0, phase_shift=0, cmap_eof=None,
                   cmap_phase=None, figsize=(8.3, 5.0), resolution='110m',
                   projection=None, orientation='horizontal', land=True):
    """Cartopy map figure of `mode` for the labeled-array API.

    Visual contract of reference ``xMCA.plot`` (xmca/xarray.py:989-1237);
    returns (fig, axes) with axes keyed [panel_kind][field_key].
    """
    import matplotlib.pyplot as plt

    analysis = model._analysis
    is_complex = analysis['is_complex']

    explained = float(
        np.asarray(model.explained_variance(mode).sel(mode=mode))
    )
    series = model.pcs(mode, scaling='max', phase_shift=phase_shift)
    phases = model.spatial_phase(mode, phase_shift=phase_shift)
    maps = (model.spatial_amplitude(mode, scaling='max') if is_complex
            else model.eofs(mode, scaling='max'))

    field_keys = list(series)
    kind = 'Amplitude' if is_complex else 'EOF'
    vmin, vmax = (0, 1) if is_complex else (-1, 1)
    map_ticks = [vmin, vmax] if is_complex else [vmin, 0, vmax]
    cmaps = {
        'map': cmap_eof or _CMAP_DEFAULTS[kind],
        'phase': cmap_phase or _CMAP_DEFAULTS['Phase'],
    }

    canvas = _MapCanvas(projection, resolution=resolution, land=land)
    n_rows, n_cols, heights, widths, cells = _plan_grid(
        len(field_keys), is_complex, orientation
    )
    fig = plt.figure(figsize=figsize, dpi=150)
    gs = fig.add_gridspec(
        n_rows, n_cols, height_ratios=heights, width_ratios=widths
    )

    # axes dict shaped like the reference's return value
    axes = {'pc': {}, 'eof': {}}
    if is_complex:
        axes['phase'] = {}
    panel_of = {'series': 'pc', 'map': 'eof', 'phase': 'phase'}

    meshes = {}
    for i, key in enumerate(field_keys):
        pc = np.asarray(series[key].sel(mode=mode)).real
        field = maps[key].sel(mode=mode)
        phase = phases[key].sel(mode=mode)
        visible = abs(field) >= threshold
        field = field.where(visible)
        phase = phase.where(visible)

        ax = fig.add_subplot(gs[cells['series', i]])
        _draw_series(ax, pc, _bold(model._field_names[key]))
        axes['pc'][key] = ax

        values, lon, lat = _panel_grid_coords(field)
        ax = canvas.add_axes(fig, gs[cells['map', i]], key)
        meshes['map'] = canvas.paint(
            ax, key, lon, lat, np.real(values), cmaps['map'], vmin, vmax
        )
        axes['eof'][key] = ax

        if is_complex:
            values, lon, lat = _panel_grid_coords(phase)
            ax = canvas.add_axes(fig, gs[cells['phase', i]], key)
            meshes['phase'] = canvas.paint(
                ax, key, lon, lat, np.real(values), cmaps['phase'],
                -np.pi, np.pi,
            )
            axes['phase'][key] = ax

    cbar_orientation = orientation
    for grid_kind, ticks, labels in [
        ('map', map_ticks, None),
        ('phase', *_PHASE_TICKS) if is_complex else (None, None, None),
    ]:
        if grid_kind is None:
            continue
        cax = fig.add_subplot(gs[cells[grid_kind, 'cbar']])
        plt.colorbar(meshes[grid_kind], cax=cax,
                     orientation=cbar_orientation)
        tick_axis = cax.xaxis if orientation == 'horizontal' else cax.yaxis
        tick_axis.set_ticks(ticks)
        if labels is not None:
            if orientation == 'horizontal':
                cax.set_xticklabels(labels)
            else:
                cax.set_yticklabels(labels)
        axes[panel_of[grid_kind]]['cb'] = cax

    # titles / spine cosmetics per orientation
    first = field_keys[0]
    if orientation == 'horizontal':
        axes['pc'][first].set_title(_bold('PC'), fontweight='bold')
        axes['eof'][first].set_title(_bold(kind), fontweight='bold')
        if is_complex:
            axes['phase'][first].set_title(_bold('Phase'),
                                           fontweight='bold')
        if len(field_keys) == 2:
            axes['pc'][first].xaxis.set_visible(False)
            axes['pc'][first].spines['bottom'].set_visible(False)
    else:
        axes['pc'][first].set_ylabel(_bold('PC'), fontweight='bold')
        axes['eof'][first].set_title(
            _bold(model._field_names[first]), fontweight='bold')
        cax = axes['eof']['cb']
        cax.set_ylabel(_bold(kind), fontweight='bold')
        cax.yaxis.set_label_position('left')
        cax.yaxis.set_ticks_position('left')
        if len(field_keys) == 2:
            second = field_keys[1]
            axes['pc'][second].yaxis.set_visible(False)
            axes['pc'][second].spines['left'].set_visible(False)
            axes['eof'][second].set_title(
                _bold(model._field_names[second]), fontweight='bold')
        if is_complex:
            cax = axes['phase']['cb']
            cax.set_ylabel(_bold('Phase'), fontweight='bold')
            cax.yaxis.set_label_position('left')
            cax.yaxis.set_ticks_position('left')

    fig.subplots_adjust(wspace=.1)
    fig.suptitle(
        _bold('Mode {:d} ({:.1f} %)'.format(mode, explained)),
        horizontalalignment='left',
    )
    return fig, axes

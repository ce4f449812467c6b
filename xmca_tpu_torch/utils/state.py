"""Carry a solved model's state between the JAX package and the port.

:func:`to_state` reads the solution of either package's ``MCA`` (duck
typed: no JAX import here) into a dict of numpy arrays and plain
values, the packed (preprocessed) fields included; :func:`install_state`
writes such a dict into a port model (as tensors on its device) or into a
JAX model (as the host numpy arrays its getters read).  A test can then
solve with one package and go on with ``rotate``, ``rule_n`` or any
result getter in the other.
"""
import copy

import numpy as np
import torch

__all__ = ['to_state', 'install_state']

_META = ('_keys', '_shape', '_n_observations', '_n_variables',
         '_fields_spatial_shape', '_field_names', '_complexify_pending',
         '_solver_method')
_ARRAYS = ('_field_means', '_field_stds', '_no_nan_index', '_norm')
_PLAIN = ('_singular_values', '_variance', '_var_idx', '_rotation_matrix',
          '_correlation_matrix')


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def to_state(model):
    """Solution state of a solved ``MCA`` (JAX package or port)."""
    state = {name: copy.deepcopy(getattr(model, name)) for name in _META}
    for name in _ARRAYS:
        state[name] = {k: _np(v) for k, v in getattr(model, name).items()}
    for name in _PLAIN:
        state[name] = _np(getattr(model, name))
    state['_V'] = {k: _np(v) for k, v in model._V.items()}
    state['_fields'] = {k: _np(v) for k, v in model._fields.items()}
    state['_analysis'] = dict(model._analysis)
    return state


def install_state(model, state, hilbert=None):
    """Install ``state`` into ``model``.

    A port model receives its fields and singular vectors as tensors on
    its device, plus the optional Hilbert operator ``hilbert`` (numpy;
    otherwise built on first use); on a mesh with a 'space' axis (set
    before the install) each rank keeps its block of the fields' columns
    and its rows of the singular vectors.  Any other model is taken to be the
    JAX package's and receives numpy arrays.
    """
    from xmca_tpu_torch.api.array import MCA
    for name in _META:
        setattr(model, name, copy.deepcopy(state[name]))
    for name in _ARRAYS:
        setattr(model, name, {k: np.array(v)
                              for k, v in state[name].items()})
    for name in _PLAIN:
        setattr(model, name, np.array(state[name]))
    model._analysis = dict(state['_analysis'])
    if isinstance(model, MCA):
        dev = model._device
        for name in ('_V', '_fields'):
            setattr(model, name, {k: torch.as_tensor(np.array(v), device=dev)
                                  for k, v in state[name].items()})
        if hilbert is not None:
            model._hilbert = torch.as_tensor(np.array(hilbert), device=dev)
        model._shard_cols = None
        model._shard_solution()
    else:
        model._V = {k: np.array(v) for k, v in state['_V'].items()}
        model._fields = {k: np.array(v) for k, v in state['_fields'].items()}
        # the JAX model's device copy of the rotation matrix
        model._R_dev_cache = None

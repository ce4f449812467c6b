"""The cells' input fields, drawn on the card from the run's seed.

A frozen copy of the red-spectrum generator of the smoke script
(``make_fields_on_card``), the same kind of field as the JAX package's
``bench.py``: per field, 8 sinusoidal time modes (1 to 8 periods over
the record) with standard normal spatial patterns, plus unit normal
noise, float32, drawn by a seeded ``torch.Generator`` on the device in
two large calls and copied to the host once, as the arrays a user
passes.  The same seed gives the same fields.
"""
import numpy as np
import torch

N_MODES = 8


def field_seeds(seed):
    """Generator seeds of the left and right fields of run seed ``seed``
    (any whole number; torch takes seeds below 2^64)."""
    base = (int(seed) * 2) % (2 ** 63)
    return base, base + 1


def draw_field(n_obs, p, seed, device):
    """One (n_obs, p) float32 field on ``device``."""
    t = torch.arange(n_obs, dtype=torch.float32, device=device)
    k = torch.arange(1, N_MODES + 1, dtype=torch.float32, device=device)
    modes = torch.sin(2 * np.pi * t[:, None] * k[None, :] / n_obs)
    gen = torch.Generator(device=device).manual_seed(seed)
    data = modes @ torch.randn((N_MODES, p), generator=gen, device=device)
    data += torch.randn((n_obs, p), generator=gen, device=device)
    return data


def coords(config):
    """The fields' coordinates: ``n_obs`` steps, ``n_lat`` latitudes
    evenly from ``lat_range[0]`` to ``lat_range[1]`` and ``n_lon``
    longitudes evenly over ``lon_range``, both ends included."""
    return {'time': np.arange(config['n_obs'], dtype=np.float32),
            'lat': np.linspace(*config['lat_range'], config['n_lat'],
                               dtype=np.float32),
            'lon': np.linspace(*config['lon_range'], config['n_lon'],
                               dtype=np.float32)}


def host_fields(n_obs, n_lat, n_lon, seed, device):
    """The left and right fields as host float32 arrays (n_obs, n_lat,
    n_lon), each drawn on ``device`` and copied to the host."""
    out = []
    for s in field_seeds(seed):
        data = draw_field(n_obs, n_lat * n_lon, s, device)
        out.append(data.cpu().numpy().reshape(n_obs, n_lat, n_lon))
        del data
    return out

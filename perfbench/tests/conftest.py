"""Harness tests (CPU; the ``cuda``-marked ones decide inside the test
whether there is a card).  Run from the repository root:
``python -m pytest perfbench/tests -q``."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(n_obs=64, n_lat=8, n_lon=16)


def tiny_spec(name):
    """The cell ``name`` at a size the CPU runs in a second: 64 steps x
    8 x 16 cells, at most 4 runs a call, 8-step blocks."""
    from perfbench.harness import Spec
    spec = Spec(name)
    spec.config.update(TINY)
    if 'runs_per_call' in spec.traffic:
        spec.traffic['runs_per_call'] = min(4, spec.traffic['runs_per_call'])
    if 'block_size' in spec.traffic.get('kwargs', {}):
        spec.traffic['kwargs']['block_size'] = 8
    return spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return 'cuda'

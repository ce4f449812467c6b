"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names, and the reference takes nothing from the package under
test."""
import ast
import os
import subprocess
import sys

import pytest

from perfbench.harness import FORBIDDEN, ROOT, forbidden_modules

BENCH_DIR = os.path.join(ROOT, 'perfbench')


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize('names, bad', [
    (['xmca_tpu_torch', 'xmca_tpu_torch.api.array'], []),
    (['xmca_tpu'], ['xmca_tpu']),
    (['xmca_tpu.x', 'numpy'], ['xmca_tpu.x']),
    (['jax', 'jaxlib.xla_client', 'flax.linen'],
     ['flax.linen', 'jax', 'jaxlib.xla_client']),
    (['jaxtyping', 'flaxen', 'xmca_tpu_tools'], []),
])
def test_top_level_names_are_compared_whole(names, bad):
    assert forbidden_modules(names) == bad


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in _sources(BENCH_DIR):
        for name in _imports(path):
            assert name.split('.')[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_package():
    for path in _sources(os.path.join(BENCH_DIR, 'reference')):
        for name in _imports(path):
            top = name.split('.')[0]
            assert top != 'xmca_tpu_torch', (path, name)
            assert (top != 'perfbench'
                    or name.startswith('perfbench.reference')), (path, name)


def test_a_run_of_every_cell_loads_no_jax():
    """A tiny run of every cell on the CPU in a fresh process, then a look
    at every module it loaded."""
    code = '''
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny_spec
from perfbench import harness
for cell in {cells!r}:
    harness.run(tiny_spec(cell), 2 ** 31 + 7, 0.0, False,
                time.perf_counter(), device='cpu')
import json
print(json.dumps(harness.forbidden_modules()))
'''
    from perfbench.tests.test_pb_layout import CELLS
    out = subprocess.run(
        [sys.executable, '-c', code.format(
            root=ROOT, tests=os.path.join(BENCH_DIR, 'tests'),
            cells=CELLS)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=''))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'

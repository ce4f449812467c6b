"""With the timed path broken underneath, a run of every cell comes out
not correct: an answer altered where it is produced, and half of the
work left out with the mean taken over the rest."""
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import tiny_spec
from perfbench.tests.test_pb_layout import CELLS


# an altered answer: its leading mode 10% larger (the widest limit, the
# bootstrap's, is 3%)
ALTER = 1.1


def _scale_lead(x, factor=ALTER):
    x = x.copy()
    x[..., 0] *= factor
    return x


def alter_answer(monkeypatch, kind):
    """Each answer's leading mode made 10% larger where it is produced."""
    from xmca_tpu_torch.api import array as api
    from xmca_tpu_torch.stats import significance as sig
    if kind == 'rule_n':
        orig = sig.rule_n_spectra

        def spectra(*a, **kw):
            s, totals, it = orig(*a, **kw)
            return _scale_lead(s), totals, it
        monkeypatch.setattr(sig, 'rule_n_spectra', spectra)
    elif kind == 'bootstrapping':
        orig = sig.bootstrap_spectra

        def boot(*a, **kw):
            s, conv = orig(*a, **kw)
            return _scale_lead(s), conv
        monkeypatch.setattr(sig, 'bootstrap_spectra', boot)
    else:
        orig = api._promax

        def promax(*a, **kw):
            B, R, phi, conv, n = orig(*a, **kw)
            B = B.clone()
            B[:, 0] *= ALTER
            return B, R, phi, conv, n
        monkeypatch.setattr(api, '_promax', promax)


def drop_half(monkeypatch, kind):
    """Every Gram summed over half of its columns, times two: the mean
    taken over the rest."""
    if kind == 'rule_n':
        from xmca_tpu_torch.ops import syrk as mod
        orig = mod.syrk

        def syrk(X, pm1=False):
            X = X.clone()
            X[:, X.shape[1] // 2:] = 0
            return orig(X, pm1=pm1) * 2
        monkeypatch.setattr(mod, 'syrk', syrk)
    else:
        from xmca_tpu_torch.core import fastpath
        orig = fastpath._data_dot

        def data_dot(a, b):
            if a.shape[1] > a.shape[0] and b.shape[1] == a.shape[0]:
                k = a.shape[1] // 2
                return orig(a[:, :k], b[:k]) * 2
            return orig(a, b)
        monkeypatch.setattr(fastpath, '_data_dot', data_dot)


@pytest.mark.parametrize('fault', [alter_answer, drop_half])
@pytest.mark.parametrize('cell', CELLS)
def test_broken_path_is_not_correct(monkeypatch, cell, fault):
    spec = tiny_spec(cell)
    fault(monkeypatch, spec.traffic['driver'])
    result, compared, notes = harness.run(spec, 2 ** 31 + 13, 0.2, False,
                                          time.perf_counter(), device='cpu')
    assert not result['correct'], compared
    assert notes or any(v > lim for _, v, lim in compared)


def test_faults_leave_the_package_as_it_was():
    # monkeypatch undoes each fault: a clean run after them is correct
    spec = tiny_spec(CELLS[0])
    result, _, _ = harness.run(spec, 2 ** 31 + 13, 0.2, False,
                               time.perf_counter(), device='cpu')
    assert result['correct'] and torch.get_default_dtype() == torch.float32

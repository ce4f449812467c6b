"""One unrotated Rule-N run, in plain PyTorch: the reference of a Rule-N
test on an unrotated complexified MCA, which is how Overland and
Preisendorfer (1982) define it and how xmca's tutorial runs it, after
``solve`` and before ``rotate``.

It imports nothing of the package under test.  A run of run seed ``s``
takes two +-1 fields from the frozen draw
(:func:`perfbench.reference.philox.pm1_field`, seeds ``2 s`` and ``2 s +
1`` mod 2^32), centres them, folds their Grams with the analytic-signal
matrix ``A``, regularizes them at the Rule-N jitter, and takes their
Cholesky factors and the reduced kernel ``M = La^H Lb / (n - 1)``, all as
:mod:`perfbench.reference.mca` does for the rotated run.  Its spectrum
is ``M``'s top k singular values by the configured subspace rounds from
``randn((n, k + 16))`` of a CPU generator seeded with ``s``; its total
is the exact nuclear norm of ``M`` (the package takes an iterative one).
It runs in the precision it is given: float64 for the check, float32
with TF32 products for the control (:func:`perfbench.checks.precision`
sets TF32).
"""
import numpy as np
import torch

from perfbench.reference import mca
from perfbench.reference.philox import pm1_field


def rulen_unrot_run(s, n, ps, dt, device, A, k=10, n_iter=6,
                    jitter_rel=2e-3):
    """``(top k singular values of M, largest first, as float64 numpy;
    M's exact nuclear norm)`` of run seed ``s`` on fields of ``n`` steps
    and widths ``ps``."""
    Xs = [pm1_field((2 * s + i) & 0xFFFFFFFF, n, p, device)
          for i, p in enumerate(ps)]
    mus = [X.sum(dim=0, dtype=torch.int64).to(dt) / n for X in Xs]
    grams = [mca.analytic_gram(mca.gram(mca._pm1_blocks(X, mu, dt), n, dt,
                                        device), A)
             for X, mu in zip(Xs, mus)]
    del Xs, mus
    gen = torch.Generator().manual_seed(int(s))
    omega = torch.randn((n, min(k + 16, n)), generator=gen,
                        dtype=torch.float32).to(device)
    _, _, M, _, sv, _ = mca._solve(grams, ps, n - 1, omega, k, n_iter,
                                   jitter_rel, mca.F32_EPS)
    del grams
    return sv.cpu().numpy().astype(np.float64), nuclear_norm(M)


def nuclear_norm(M):
    """``sum(svdvals(M))`` of a square complex ``M``, as the square roots
    of the eigenvalues of ``M^H M`` formed and decomposed in complex128
    whatever ``M``'s precision: the exact nuclear norm of the ``M`` given.
    A value s of ``M`` comes out within ~eps64 ||M||^2 / s of its own, so
    at n = 2000 even the jitter-level ones (1e-5 of the largest) move the
    total by under 1e-8; the card's Hermitian eigensolver takes a fraction
    of the time of its complex SVD."""
    Mh = M.to(torch.complex128)
    w = torch.linalg.eigvalsh(Mh.mH @ Mh)
    return float(torch.sum(torch.sqrt(torch.clamp(w, min=0.0))))

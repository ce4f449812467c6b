"""Package version, git-derived when running from a checkout.

The port's own copy of ``xmca_tpu/version.py`` (the port imports nothing
of the JAX package): a git checkout reports ``<base>.post<commits>``;
source distributions and environments without git report the pinned
base version.  Both packages live in one checkout, so they report the
same string.
"""
import os
import subprocess

_BASE_VERSION = '0.1.0'


def _git_version(base):
    """``<base>.post<ccount>`` from the enclosing git checkout, or None."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.isdir(os.path.join(repo, '.git')):
        return None
    try:
        out = subprocess.run(
            ['git', 'rev-list', '--count', 'HEAD'], cwd=repo,
            capture_output=True, text=True, timeout=5,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    ccount = out.stdout.strip()
    if not ccount.isdigit():
        return None
    return '{:}.post{:}'.format(base, ccount)


__version__ = _git_version(_BASE_VERSION) or _BASE_VERSION

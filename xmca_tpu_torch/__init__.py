"""xmca_tpu_torch — the xmca_tpu MCA/EOF framework on PyTorch and CUDA.

The JAX package ``xmca_tpu`` stays the reference; this package ports its
main path to torch tensors on an NVIDIA Hopper card (H100), with the
Pallas TPU kernels rewritten by hand in CUDA C++ (``csrc/``):

>>> from xmca_tpu_torch.array import MCA       # numpy-facing API
>>> from xmca_tpu_torch.xarray import xMCA     # labeled-array API
>>> m = xMCA(left, right, device='cuda')

Nothing here imports JAX or the JAX package.
"""
from xmca_tpu_torch.version import __version__

__all__ = ['__version__', 'MCA', 'xMCA']


def __getattr__(name):
    if name == 'MCA':
        from xmca_tpu_torch.api.array import MCA
        return MCA
    if name == 'xMCA':
        from xmca_tpu_torch.api.xarray import xMCA
        return xMCA
    raise AttributeError(name)

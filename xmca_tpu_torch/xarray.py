"""Import-path parity module: ``from xmca_tpu_torch.xarray import xMCA``."""
from xmca_tpu_torch.api.xarray import DataArray, xMCA

__all__ = ['DataArray', 'xMCA']

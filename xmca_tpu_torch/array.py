"""Import-path parity module: ``from xmca_tpu_torch.array import MCA``."""
from xmca_tpu_torch.api.array import MCA

__all__ = ['MCA']

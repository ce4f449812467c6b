"""Text helpers with the JAX package's ``xmca_tpu.tools.text`` entry
points (the reference's ``xmca/tools/text.py``), re-exported from the
port's own ``utils.text``."""
from xmca_tpu_torch.utils.text import boldify_str, secure_str, wrap_str  # noqa: F401

"""The program's blocking host reads and host-to-device copies (``sync``
spans) in the traced window over its bootstrap runs."""
from perfbench.program_trace import syncs_per_run as read  # noqa: F401

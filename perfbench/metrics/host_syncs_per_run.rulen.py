"""The program's blocking host reads and host-to-device copies (``sync``
spans) in the traced window over its Rule-N runs."""
from perfbench.program_trace import syncs_per_run as read  # noqa: F401

"""Share (%) of the device's idle time in the traced window (the gaps
between its operations) spent in gaps inside which one of the program's
``sync`` spans ends: the idle time a blocking host read or copy
accounts for."""
from perfbench.program_trace import idle_after_sync as read  # noqa: F401

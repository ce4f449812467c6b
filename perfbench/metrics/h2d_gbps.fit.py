"""Host-to-device rate of a fit's ingest (GB/s): the bytes of the
program's ``ingest.copy`` spans (each field's upload) over their summed
host seconds."""
from perfbench.program_trace import copy_gbps


def read(ctx):
    return copy_gbps(ctx, 'ingest.copy')

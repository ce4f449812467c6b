"""Run one cell of the benchmark of ``xmca_tpu_torch`` on this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as its last line on standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; then the numbers
the check compared, each with its limit, under ``checks``.  Exits
non-zero without a result when the machine has fewer CUDA devices than
the cell asks for, or when the run loaded JAX or the JAX package.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == '__main__':
    from perfbench.harness import main
    sys.exit(main())

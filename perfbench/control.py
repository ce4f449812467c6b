"""The control of a cell's check: the reference in the program's place,
computed in float32 with TF32 products (the precision below the
configuration's float32 with TF32 off), judged by the same comparison
as a run of the program.  Its numbers are the upper readings each limit
in ``workloads/<cell>.json`` is set below; the benchmark's own runs
never run it.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it draws the cell's inputs as a run does, fills the
answers the check would sample from a window of ``--calls`` calls with
the control's (the cell's driver: ``fill``), and prints one JSON line of
the compared numbers.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def control_records(calls, seed, check, n_calls, device):
    """Records of ``n_calls`` window calls whose sampled answers are the
    control's (float32 with TF32 products) and the rest blank."""
    from perfbench import checks
    from perfbench.calls import CALL, derive
    drv = calls.driver
    records = []
    for i in range(n_calls):
        records.extend(drv.blank(calls, derive(calls.seed, CALL, i)))
    picks = checks.samples(records, seed, int(check['samples']),
                           drv.per_call(calls.traffic))
    with checks.precision('tf32') as dt:
        ref = checks.Reference(calls, dt, device)
        for ci, r in picks:
            drv.fill(ref, records[ci], r)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--calls', type=int, default=16,
                    help='window calls the sample is drawn from')
    args = ap.parse_args(argv)
    from perfbench import checks
    from perfbench.calls import Calls
    from perfbench.harness import Spec
    spec = Spec(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        calls = Calls(spec.config, spec.traffic, seed, 'cuda')
        calls.make_fields()
        records = control_records(calls, seed, spec.check, args.calls,
                                  'cuda')
        numbers, notes = checks.compare(calls, records, seed, spec.check,
                                        'cuda')
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'control': 'tf32', 'numbers': numbers,
                          'notes': notes,
                          'seconds': time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

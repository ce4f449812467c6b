"""One run of one cell: set-up, the measured window, the check and the
result line.

The cell, its configuration, its traffic (and the traffic's driver),
its check and its per-layer metrics are all found by name from
``BENCHMARK.json``; nothing here names a cell.  End-to-end metrics come from the host clock around the
window (a rate over all the work and all the time of the window) and
from ``torch.cuda.max_memory_allocated`` (reset as the window starts);
per-layer metrics, in a ``--trace 1`` run, from the readers in
``metrics/`` over the device trace of ``trace_calls`` calls and the
harness's own spans.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules that must not be loaded in a run of the package under test,
# compared by whole top-level names
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'xmca_tpu')


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Spec:
    """A cell as the files name it: ``entry`` (its line in
    ``BENCHMARK.json``), ``config``, ``traffic`` (which names its
    driver, ``drivers/<name>.py``), ``check``, and the end-to-end and
    per-layer metrics it reports."""

    def __init__(self, name, root=ROOT):
        bench = load_json(root, 'BENCHMARK.json')
        cells = {w['name']: w for w in bench['workloads']}
        if name not in cells:
            raise SystemExit('unknown workload {!r}; BENCHMARK.json has {}'
                             .format(name, sorted(cells)))
        self.entry = cells[name]
        self.name = name
        cfg = {c['name']: c for c in bench['configs']}[self.entry['config']]
        self.config = load_json(root, cfg['file'])
        self.traffic = load_json(root, 'perfbench', 'traffic',
                                 self.entry['traffic'] + '.json')
        self.check = load_json(root, 'perfbench', 'workloads',
                               name + '.json')['check']

        def mine(m):
            return name in m.get('workloads', [name])
        self.end_to_end = [m for m in bench['end_to_end'] if mine(m)]
        e2e = {m['name'] for m in self.end_to_end}
        self.per_layer = [m for m in bench['per_layer']
                          if mine(m) and m['moves'] in e2e]


def reader(metric, root=ROOT):
    """The ``read(ctx)`` function of a per-layer metric's file,
    ``metrics/<name>.py``."""
    path = os.path.join(root, 'perfbench', 'metrics', metric + '.py')
    spec = importlib.util.spec_from_file_location(
        'perfbench_metric_' + metric.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split('.')[0] in FORBIDDEN)


def card_line():
    """The card's name, power limit, SM clock, its maximum and the
    temperature, from nvidia-smi."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,'
             'clocks.max.sm,temperature.gpu', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi unavailable'


def _sync(device):
    import torch
    if str(device).startswith('cuda'):
        torch.cuda.synchronize()


def window(calls, seconds, trace_calls=None):
    """Closed-loop calls until ``seconds`` have passed (the last call
    starts before the deadline), or ``trace_calls`` calls under the
    device tracer.  Returns ``(units, number of calls, elapsed seconds,
    per-call walls, device activity or None)``."""
    from perfbench.trace import Tracer
    walls, units, k = [], 0, 0
    tracer = Tracer() if trace_calls else None
    _sync(calls.device)
    if tracer:
        tracer.__enter__()
    start = time.perf_counter()
    deadline = start + seconds
    try:
        while (k < trace_calls if tracer
               else k == 0 or time.perf_counter() < deadline):
            t0 = time.perf_counter()
            units += calls.call(k)
            walls.append(time.perf_counter() - t0)
            k += 1
        _sync(calls.device)
        elapsed = time.perf_counter() - start
    finally:
        if tracer:
            tracer.__exit__(*sys.exc_info())
    return units, k, elapsed, walls, tracer.activity if tracer else None


def run(spec, seed, seconds, trace, t_start, device='cuda'):
    """Set-up, window, check; returns ``(result dict, compared numbers
    as [(name, value, limit)], notes)``."""
    import torch
    from perfbench import checks
    from perfbench.calls import Calls

    cuda = str(device).startswith('cuda')
    checks.follow(spec.config['pipeline'])
    t0 = time.perf_counter()
    if cuda:
        from xmca_tpu_torch.ops import _build
        _build.library()
    calls = Calls(spec.config, spec.traffic, seed, device)
    calls.setup_walls['import and kernel load'] = time.perf_counter() - t0
    calls.setup()
    if trace:
        calls.spans = {}
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    units, n_calls, elapsed, walls, activity = window(
        calls, seconds, spec.traffic['trace_calls'] if trace else None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print('card: {}; TF32 matmul {}; setup {:.4f} s; window '
          '{:.4f} s, {} calls, {} units; per-call walls (s): {}'.format(
              card_line() if cuda else 'none (cpu)',
              torch.backends.cuda.matmul.allow_tf32, setup_s,
              elapsed, n_calls, units,
              ' '.join('{:.4f}'.format(w) for w in walls)),
          file=sys.stderr)
    print('setup steps (s): {}; before them {:.4f} s'.format(
        ', '.join('{} {:.4f}'.format(k, v)
                  for k, v in calls.setup_walls.items()),
        t0 - t_start), file=sys.stderr)
    if activity is not None:
        for name, sec in activity.top_kernels(10):
            print('device op {:.6f} s: {}'.format(
                sec, activity.raw_names.get(name, name)[:300]),
                file=sys.stderr)
    spans = calls.spans
    calls.release()

    t_check = time.perf_counter()
    numbers, notes = checks.compare(calls, calls.records, seed, spec.check,
                                    device)
    print('check {:.3f} s'.format(time.perf_counter() - t_check),
          file=sys.stderr)
    limits = spec.check['limits']
    compared = [(k, v, limits[k]) for k, v in numbers.items()]
    correct = not notes and all(v <= lim for _, v, lim in compared)

    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
                   'count': int(spec.entry['chips']),
                   'memory_peak_bytes': int(peak)}
    metrics = {}
    breakdown = None
    if not trace:
        values = {'setup_s': setup_s, 'peak_mem_gb': peak / 1e9,
                  spec.traffic['rate_metric']: elapsed / units}
        for m in spec.end_to_end:
            if m['name'] in values:
                metrics[m['name']] = {'value': values[m['name']],
                                      'unit': m['unit']}
    else:
        busy = activity.busy_s()
        device_info['busy_s'] = busy
        device_info['window_s'] = elapsed
        ctx = {'activity': activity, 'window_s': elapsed, 'units': units,
               'calls': n_calls, 'spans': spans or {}, 'config': spec.config,
               'traffic': spec.traffic}
        for m in spec.per_layer:
            value = reader(m['name'])(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        breakdown = {'device_ops': activity.top_kernels(10),
                     'idle_gaps': activity.idle_gaps(10)}
    result = {'correct': bool(correct), 'attempted': n_calls,
              'failed': len(notes), 'metrics': metrics,
              'device': device_info}
    if breakdown is not None:
        result['breakdown'] = breakdown
    return result, compared, notes


def main(argv=None):
    import argparse
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's build and kernel caches stay in the checkout, at fixed
    # paths (the package builds its kernels into build/xmca_tpu_torch)
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build',
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')
    os.environ['USE_FLAX'] = '0'
    spec = Spec(args.workload)

    import torch
    chips = int(spec.entry['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('perfbench: the cell needs {} CUDA device(s); this machine '
              'has {}'.format(chips, torch.cuda.device_count()
                              if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    result, compared, notes = run(spec, args.seed, args.seconds,
                                  bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        print('perfbench: the run loaded {}'.format(', '.join(bad)),
              file=sys.stderr)
        return 3
    result['checks'] = {k: {'value': v, 'limit': lim}
                        for k, v, lim in compared}
    for note in notes:
        print('check: {}'.format(note), file=sys.stderr)
    for k, v, lim in compared:
        print('check {}: {!r} (limit {!r})'.format(k, v, lim),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0

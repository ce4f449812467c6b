"""Device activity of a traced window, from ``torch.profiler``'s trace.

The profiler records CUDA activity only (kernels, copies, sets), so the
host pays no per-operator cost.  Its Chrome trace is read back from a
file under ``TMPDIR`` and reduced to :class:`Activity`: each kernel's
base name, start and length, the copies' and sets' intervals, and the
idle gaps between them, each named after the kernels on either side
(what the host was issuing between them).
"""
import json
import os
import tempfile

_KERNEL_CATS = ('kernel',)
_OTHER_CATS = ('gpu_memcpy', 'gpu_memset')


# base names too generic to tell kernels apart: the first template
# argument's base name is kept beside them
_GENERIC = ('kernel', 'Kernel', 'Kernel2')


def _strip(name):
    """``name`` up to its parameter list, without template arguments, and
    its first template argument (or '')."""
    depth, out, first = 0, [], []
    for ch in name:
        if ch == '<':
            depth += 1
            if depth == 1 and not first:
                first.append('')
            continue
        if ch == '>':
            depth = max(0, depth - 1)
            continue
        if depth == 0:
            if ch == '(':
                break
            out.append(ch)
        elif depth == 1 and len(first) == 1 and ch not in ', ':
            first[0] += ch
        elif depth == 1 and ch == ',' and len(first) == 1:
            first.append(None)
    return ''.join(out), (first[0] if first else '')


def kernel_base_name(name):
    """A kernel's name without its return type, namespaces, template
    arguments and parameter list: ``void ns::k<1>(float*)`` -> ``k``; a
    generic name keeps its first template argument's base name:
    ``kernel<getrf_params_<float2, 0> >(int)`` -> ``kernel<getrf_params_>``."""
    name = name.replace('(anonymous namespace)::', '').strip()
    if name.startswith('void '):
        name = name[5:]
    base, first = _strip(name)
    base = base.split('::')[-1].strip() or name
    if base in _GENERIC and first:
        base = '{}<{}>'.format(base, first.split('::')[-1])
    return base


class Activity:
    """Kernels as ``(base name, start_us, dur_us)``, every device
    operation (kernels, copies, sets) likewise in ``ops``, and its
    interval as ``(start_us, end_us)``."""

    def __init__(self, kernels, others, raw_names=None):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.ops = sorted(self.kernels + list(others), key=lambda k: k[1])
        # base name -> one full name it stands for
        self.raw_names = raw_names or {}
        self.intervals = [(s, s + d) for _, s, d in self.ops]

    @classmethod
    def from_trace_events(cls, events):
        kernels, others, raw = [], [], {}
        for ev in events:
            if ev.get('ph') != 'X':
                continue
            cat = ev.get('cat', '')
            if cat in _KERNEL_CATS:
                base = kernel_base_name(ev.get('name', ''))
                raw.setdefault(base, ev.get('name', ''))
                kernels.append((base, float(ev['ts']),
                                float(ev.get('dur', 0.0))))
            elif cat in _OTHER_CATS:
                others.append((ev.get('name', cat), float(ev['ts']),
                               float(ev.get('dur', 0.0))))
        return cls(kernels, others, raw)

    def busy_s(self):
        """Seconds in which some operation ran on the device (the union
        of the intervals)."""
        total, end = 0.0, None
        for s, e in self.intervals:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-6

    def kernel_s(self, names=None, exclude=()):
        """Summed kernel seconds, of ``names`` only when given, never of
        ``exclude``."""
        return 1e-6 * sum(d for n, _, d in self.kernels
                          if (names is None or n in names)
                          and n not in exclude)

    def launches(self):
        return len(self.kernels)

    def top_kernels(self, count=10):
        """``[[name, seconds], ...]``: the kernels with the most device
        time, summed by name."""
        sums = {}
        for n, _, d in self.kernels:
            sums[n] = sums.get(n, 0.0) + d * 1e-6
        return [[n, s] for n, s in sorted(sums.items(),
                                          key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count=10):
        """``[[label, seconds], ...]``: the device's idle time between
        consecutive operations (kernels, copies, sets), summed by the
        pair of operations around each gap, the largest sums first."""
        sums, end, prev = {}, None, None
        for n, s, d in self.ops:
            if end is not None and s > end:
                label = '{} -> {}'.format(prev, n)
                sums[label] = sums.get(label, 0.0) + (s - end) * 1e-6
            if end is None or s + d > end:
                end = s + d
            prev = n
        return [[k, v] for k, v in sorted(sums.items(),
                                          key=lambda kv: -kv[1])[:count]]


class Tracer:
    """``with Tracer() as t: ...`` records the device's activity in the
    block; ``t.activity`` holds it afterwards.  Imports
    ``torch.profiler`` only when it starts."""

    def __init__(self):
        self.activity = None
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get('traceEvents', [])
        finally:
            os.remove(path)
        self.activity = Activity.from_trace_events(events)
        self._prof = None
        return False

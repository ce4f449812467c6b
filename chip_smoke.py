"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from ``xmca_tpu_torch/csrc`` (nvcc,
   sm_90a), prints their registers, shared memory and spills, the card,
   its power limit and the TF32 flags;
2. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at small ragged ones (K3: its column-chunk
   edges too, and its device memory), and times both, the one library
   call that computes the same function where there is one (syrk:
   ``torch._int_mm``, ``torch.mm``), a composite yardstick where there is
   none (K3, K4: the stored field, then K1 or ``torch.mm``), and the
   kernel's bound: the largest of its operations over the card's
   published peak, its bytes over the memory rate and its Philox calls
   over the SMs' issue rate (PHILOX_SASS_PER_CALL instructions each);
   K1 (syrk) with the median, least and largest of its per-launch
   times, and in the tile order of each band height of SYRK_BANDS
   (``syrk_sweep``: bit-equal, timed, the row panels a wave reads);
   the SES sweep kernel (``check_ses``) at the monthly deployment's
   (480, 2076480), coarse and refined grids, against the plain loop on
   the card, timed beside its least time, its registers and spills;
   the +-1 back-projection kernel (``check_pm1_project``) at PM1_SHAPES
   against an f64 product and its plain blocked version, timed beside
   its bound, the plain version and ``torch.mm(X.float().T, S_pad)``;
3. drives the main path once through the public API at full width: two
   synthetic (2000 steps x 250 x 400 cells) f32 fields through
   ``xMCA -> set_solver(truncate=10) -> normalize -> apply_coslat ->
   solve(complexify=True) -> rotate(10) -> rule_n(N_RUNS)``, with the
   kernels' launch counters reset just before and read just after; then
   (``project_blocks``) the kernel's +-1 back-projection of a run of
   that model against the plain version in one and in PROJECT_BLOCKS
   column blocks and an f64 product, each timed;
4. ``result_path``: every result getter (EOFs, PCs, amplitude and phase,
   both correlation patterns, reconstruction, ``fields``, ``predict``,
   ``scf``, rotation and correlation matrices) on the main path's model,
   with the one-time materialization of the deferred complex fields
   timed on its own; checks shapes, finiteness, ``predict`` on the
   training steps against ``pcs`` and the reconstruction residuals;
5. ``dense_path``: the same fields through the exact dense solve
   (``solve(complexify=True)`` without ``truncate``), ``rotate(10)``, the
   same getters and ``rule_n(N_DENSE_RUNS)`` with the launch counters
   reset just before and read just after; its stages timed again one by
   one; its singular vectors held to the SVD residual of the cross
   covariance, and its spectrum and EOFs against the truncated model's
   where the truncated solve resolves them (EOFs within the larger of
   1e-3 and the truncated solve's Davis-Kahan bound);
6. runs the main path at a small size on the card and on the CPU (the
   plain versions, with the same random bits) and compares them; then
   the dense and the truncated model small, on the card, on the CPU and
   with the CPU's solution carried to the card, getter by getter;
7. drives the generated Rule-N surrogate
   (``core.fastpath.fast_surrogate_variance_gen``, fields generated
   inside the Gram and projection kernels, never stored) for N_GEN seeds
   at the same full width, with the counters reset just before and read
   just after, against ``fast_surrogate_variance_tri`` over the same
   seeds; then the same function small, on the card and on the CPU;
8. ``boot_path``: ``bootstrapping`` on the main path's model at full
   width (standard, iterative, and one block spanning the record, which
   reproduces the model's own data and so its rotated variance), with
   the counters reset just before and read just after (no kernel runs
   there); then a small model on the card and on the CPU with the same
   resample indices;
9. ``saveload_path`` (after ``boot_path``, on the main path's model): its
   ``info.xmca`` and the three arrays ``save_analysis`` writes, loaded
   into a fresh ``xMCA`` by the array-level ``load_analysis`` plus the
   coslat step, the load timed, its getters held to the model's, and
   ``rule_n(16)`` on both (exactly 2 x 16 launches of syrk,
   sign_field_sums and pm1_project each, the same spectra over the ratio
   of the totals);
   the file round trip where h5py is installed; a time-varying weight on
   a fresh model against numpy;
10. ``ensemble_path``: ``rule_n`` on the same model in every other
   configuration, the counters reset just before and read just after
   each: 'draw' with the fast (N = 8) and the exact (N = 2, one dense
   rotated solve a run) spectrum, no kernel launched; the generated
   'normal16', 'normal32' and 'rademacher' (N = 8, exactly 2 x N launches
   of surrogate_field and none of syrk/sign_field_sums) and
   'rademacher1' (N = 16, 2 x N of syrk, sign_field_sums and
   pm1_project, equal bit
   for bit to 'rademacher8'); each mean null within 5 standard errors of
   a +-1 null rotated to the same tolerance; then the fast against the
   exact spectrum on one field pair, the int8 full-Gram variant against
   the triangle Gram at 4 seeds, and Rule-N at 256 x 2 x 512 on the card
   against the CPU;
11. ``long_path``: a 40-year daily record, 14610 steps x 2 x (250 x 400)
   cells f32, through ``set_solver(truncate=10) -> normalize ->
   apply_coslat -> solve(complexify=True) -> rotate(10) ->
   rule_n(N_LONG_RUNS)``, longer than the analytic fold's 8192 steps;
   exactly 2 x N_LONG_RUNS launches of syrk, sign_field_sums and
   pm1_project; then
   both kernels against their plain versions at that shape, and K1 at
   it and at the fold's longest record (8192 steps) in the band sweep,
   with and without its wave barrier;
12. ``extend_path``: the main path with ``solve(complexify=True,
   extend='exp'|'theta', period=365)``, ``rule_n(16)`` (exactly 2 x 16
   launches of syrk, sign_field_sums and pm1_project each) and
   ``bootstrapping(4)``;
   with 'theta', the SES kernel launched 2 x 2 times by the solve and as
   many by each bootstrap run, and never by the Rule-N runs;
   the theta forecast's wall and launches at full width, and 4096 of its
   columns in f32 on the card against f64 on the CPU;
13. ``stream_path``: ``xMCA.from_chunks`` over the same host fields (16384-
   and 9973-column chunks, then ``extend='exp'``) through the same path,
   against the in-memory models (spectrum, EOFs, rotated variance, the
   Rule-N null over the ratio of totals; 2 x 16 launches each), each
   streamed pass's wall and rate;
14. ``extend_small`` and ``stream_small``: extended and chunk-backed models
   at 256 x 2 x 512 on the card and on the CPU;
15. ``stream_boot_path``: ``bootstrapping`` of stream_path's 16384-column
   chunk-backed model (standard and iterative on the time axis against
   the in-memory model run for run; the space axis with both fields and
   with the right one), each phase's passes a field counted by its
   loaders; ``stream_boot_small``: chunk-backed bootstraps at 256 x 2 x
   512 on the card and on the CPU;
16. ``wide_stream_path``: two 2000 x (1800 x 3600) f32 fields, 103.7 GB in
   all, streamed through the 80 GB card by ``MCA.from_chunks`` ->
   ``normalize`` -> ``solve(complexify=True)`` -> ``rotate(10)``, built of
   25 sign-flipped copies of one block each, so its Grams, spectrum and
   EOF tiles have exact references; its solve's peak device memory; and
   its bootstrap: the unrotated time axis (no pass) against the n x n
   reduction of 25 x B's Gram, the rotated time axis (one pass a field)
   against B's tile under each run's rotation, the space axis (two
   passes a field) with each run's counts-weighted Gram against B's in
   memory; then ``rule_n(N_WIDE_RUNS)`` of the rotated wide model
   (``wide_rule_n``: exactly 2 x N_WIDE_RUNS launches of syrk,
   sign_field_sums and pm1_project, its wall a run, its peak device
   memory, three column blocks of a run's back-projection and of the
   plain version's against an f64 product, both timed) and K1 and
   K2 at its (2048, 6480000) shape against their plain versions
   (``wide_kernels``), timed beside their bounds and K1's library call;
17. ``mesh_path``: the device mesh (``xmca_tpu_torch.parallel``) through
   the JAX package's multi-device flow (``dryrun_multichip``) at the main
   path's width: the unsharded flow, then (a) a world of one rank (NCCL,
   mesh (1, 1)) in this process, equal to it bit for bit with exactly
   2 x 16 and 2 x 8 launches of syrk and sign_field_sums, then (b) four
   ranks of this script (``--mesh-rank``) sharing the card over gloo,
   mesh (2, 2), each with half of each field's columns, held to it at
   MESH_TOL, with exactly 2 x 8 and 2 x 4 launches a rank; each rank's
   walls, collectives and peak memory; the flow also runs
   ``bootstrapping(4, axis=1)`` of both fields (each rank resamples its
   own columns) and ``bootstrapping(4)`` with its runs split over the
   'space' axis (each rank gathers the fields), each phase's wall a run,
   collectives, bytes and peak memory printed, no kernel launched;
18. ``int_fields_small``: an int32 field pair (256 x 2 x 512) on the card
   through ``normalize -> solve(complexify=True) -> rotate(4)`` and the
   getters, equal bit for bit to its float32 copy's model.

Any failure exits non-zero; nothing is caught.  The last lines are the
kernel table (JSON), the card's ``name, power.limit`` from nvidia-smi,
and the result line ``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import time

N_OBS, N_LAT, N_LON = 2000, 250, 400       # the bench.py workload
N_ROT = 10
N_RUNS = 64          # of the workload's 1000 surrogates: cut for time only
N_GEN = 32           # generated-surrogate runs: cut for time only
N_DENSE_RUNS = 16    # Rule-N runs of the dense path: cut for time only
N_PREDICT = 100      # time steps that predict() projects
N_BOOT = 16          # standard bootstrap runs: cut for time only
N_BOOT_ITER = 4      # iterative bootstrap runs (3 modes): cut for time only
BOOT_BLOCK = 20      # moving-block length (steps)
# one block spanning the record resamples nothing, so a run solves the
# model's own data and its rotated variance is the model's but for where
# the rotation stops: bootstrap runs rotate to tol 1e-4, the model to
# 1e-8, and a tol-1e-4 varimax stopping point moves a mode's variance by
# up to ~2% (measured on the CPU in f32 at 256-2000 steps x 2 x 512-2500
# cells: up to 5.8e-3); the sum over the modes moves far less (1.2e-6)
SINGLE_BLOCK_TOL = {'mode': 2e-2, 'sum': 1e-3}
N_LONG = 14610       # 40 years of daily steps: beyond the 8192-step fold
N_FOLD = 8192        # the analytic fold's longest record
N_LONG_RUNS = 4      # Rule-N runs of the long record: cut for time only
SEED = 7
ENSEMBLE = dict(power=1, tol=1e-4, n_iter=6, polar_method='ns14')


def _fail(msg):
    print('chip_smoke: FAILED: ' + msg, file=sys.stderr)
    sys.exit(1)


def _check(cond, msg):
    if not cond:
        _fail(msg)


def _card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _launch_ms(torch, fn, reps):
    """Device time of each of ``reps`` launches of ``fn`` (a CUDA event
    pair around each, after one warm-up call): ``{ms: the median,
    ms_min, ms_max}``."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in pairs)
    return {'ms': statistics.median(times), 'ms_min': times[0],
            'ms_max': times[-1]}


def _spread(t):
    return '{:.4f} ms (min {:.4f}, max {:.4f})'.format(t['ms'], t['ms_min'],
                                                       t['ms_max'])


def _pm1_field(torch, n, p, n_pad, p_pad, gen, dtype):
    X = torch.zeros((n_pad, p_pad), dtype=dtype, device='cuda')
    bits = torch.randint(0, 2, (n, p), generator=gen, device='cuda')
    X[:n, :p] = (bits * 2 - 1).to(dtype)
    return X


# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet),
# for each kernel's bound: the larger of its operations over the peak of
# their type and its bytes (each input read once, each output written
# once) over the memory rate.
PEAK_OPS = {'int8': 1979e12, 'bf16': 989e12, 'f32': 67e12}
PEAK_BYTES = 3.35e12
# SASS instructions of one Philox4x32-10 call (csrc/philox.cuh), counted
# by philox_sass_per_call() on 2026-10-16 (CUDA 12.8, sm_90a, -O3; NVIDIA
# H100 80GB HBM3); main() prints the count of the run beside it
PHILOX_SASS_PER_CALL = 40
SM_ISSUE_LANES = 132 * 4 * 32      # lane-instructions an SM clock, all SMs
# K1's times at (2048, 100096) before this accumulate mode (PERF.md, PR 3)
SYRK_PR3_MS = {'int8': 0.3990, 'bf16': 0.6409}
# the SMs' issue rate: 132 SMs x 4 warp-instructions a clock x 32 lanes,
# at the SM clock nvidia-smi reports as clocks.max.sm (set by main())
ISSUE = {'lanes_per_s': None}

_PHILOX_PROBE = r'''
#include "philox.cuh"
extern "C" __global__ void probe1(const uint4* in, uint4* out, unsigned k) {
  out[threadIdx.x] = xmca::philox4x32_10(in[threadIdx.x], k, 1u);
}
extern "C" __global__ void probe2(const uint4* in, uint4* out, unsigned k) {
  out[threadIdx.x] = xmca::philox4x32_10(
      xmca::philox4x32_10(in[threadIdx.x], k, 1u), k, 1u);
}
'''


def philox_sass_per_call():
    """SASS instructions of one Philox4x32-10 call: a kernel of two
    chained calls minus one of a single call, both compiled from
    ``csrc/philox.cuh`` with the library's nvcc flags and counted in
    ``cuobjdump -sass`` (the key schedule, shared by every call a thread
    makes, cancels)."""
    import os
    import re
    from xmca_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, 'philox_probe.cu')
    cubin = os.path.join(_build.BUILD_DIR, 'philox_probe.cubin')
    with open(src, 'w') as f:
        f.write(_PHILOX_PROBE)
    nvcc = _build._nvcc()
    subprocess.run([nvcc, '-cubin', '-gencode', 'arch=compute_90a,code=sm_90a',
                    '-O3', '-I', _build.CSRC_DIR, '-o', cubin, src],
                   check=True, capture_output=True, timeout=300)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), 'cuobjdump'), '-sass', cubin],
        check=True, capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r'Function : (\w+)', line)
        if m:
            name = m.group(1)
            counts[name] = 0
            continue
        m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+([A-Z@!][\w.@!]*)', line)
        if name and m and m.group(1) != 'NOP':
            counts[name] += 1
    return counts['probe2'] - counts['probe1']


def bound(ops=0.0, kind='bf16', nbytes=0.0, calls=0.0):
    """``{bound_ms, bound_by, generation_ms}`` of ``ops`` operations of
    ``kind``, ``nbytes`` bytes of memory traffic and ``calls`` Philox
    calls (PHILOX_SASS_PER_CALL instructions each at the SMs' issue
    rate): the largest of the three terms, and which one it is."""
    terms = {'operations': ops / PEAK_OPS[kind] if ops else 0.0,
             'bytes': nbytes / PEAK_BYTES,
             'generation': (calls * PHILOX_SASS_PER_CALL
                            / ISSUE['lanes_per_s'])}
    by = max(terms, key=terms.get)
    return {'bound_ms': 1e3 * terms[by], 'bound_by': by,
            'generation_ms': 1e3 * terms['generation']}


def _gram_bound(n_pad, p_pad, in_bytes, kind):
    """The lower triangle of an (n_pad, n_pad) Gram over p_pad columns:
    n_pad (n_pad + 1) / 2 p_pad multiply-adds; X read, f32 G written."""
    return bound(n_pad * (n_pad + 1) / 2 * p_pad * 2, kind,
                 n_pad * p_pad * in_bytes + n_pad * n_pad * 4)


def _kernel_name(key):
    """A profiler key without its return type, namespace and arguments."""
    key = key.replace('void ', '', 1).replace('(anonymous namespace)::', '')
    return key.split('(')[0][:48]


def _gen_calls(n, p):
    """Philox calls of an (n, p) generated field: one per 4 elements."""
    return n * -(-p // 4)


def check_syrk(torch):
    from xmca_tpu_torch.ops.syrk import pad_to, syrk, syrk_reference
    gen = torch.Generator(device='cuda').manual_seed(0)
    n_pad, p_pad = pad_to(N_OBS, N_LAT * N_LON)
    # the main path's shape, small and ragged ones, (4096, 20096) (528
    # tiles, four whole waves), one contraction block (p = 128) and a
    # padded second tile row (n = 130)
    shapes = [(N_OBS, N_LAT * N_LON), (128, 128), (200, 3000),
              (1000, 4100), (1900, 10000), (4000, 20000), (300, 128),
              (130, 5000)]
    for n, p in shapes:
        X = _pm1_field(torch, n, p, *pad_to(n, p), gen, torch.int8)
        G, ref = syrk(X, pm1=True), syrk_reference(X)
        torch.cuda.synchronize()
        _check(torch.equal(G, ref), 'syrk int8 +-1 differs at {}'
               .format((n, p)))
        Xb = X.to(torch.bfloat16)
        _check(torch.equal(syrk(Xb), syrk_reference(Xb)),
               'syrk bf16 +-1 differs at {}'.format((n, p)))
    print('syrk int8/bf16 +-1 bit-equal to plain at {}'.format(shapes))

    Xw = torch.randint(-127, 128, (256, 4096), generator=gen,
                       device='cuda').to(torch.int8)
    _check(torch.equal(syrk(Xw), syrk_reference(Xw)),
           'syrk int8 [-127, 127] differs')
    Xr = torch.randn((n_pad, p_pad), generator=gen,
                     device='cuda').to(torch.bfloat16)
    G, ref = syrk(Xr), syrk_reference(Xr)
    rel = float((G - ref).abs().max() / ref.abs().max())
    # two f32 sums of 100096 products in different orders, each with a
    # rounding walk of ~4 sqrt(n_adds) u ~ 2e-5 of the diagonal (kernel:
    # truncating wgmma chunks of 256 products folded with rounded adds;
    # plain: f32 GEMM): 1e-4
    _check(rel <= 1e-4, 'syrk bf16 random rel err {:.3e} > 1e-4'
           .format(rel))
    _check(torch.equal(G, G.T), 'syrk bf16 random not symmetric')
    _check(torch.equal(G, syrk(Xr)), 'syrk bf16 random not deterministic')
    print('syrk int8 [-127,127] bit-equal; bf16 randn at {} rel err '
          '{:.3e} (tol 1e-4), symmetric, the same bits twice'
          .format((n_pad, p_pad), rel))
    del Xr, G, ref

    # times at the main path's shape (a median of 20 launches); the
    # yardsticks compute the full (not triangular) product in one library
    # call, which the port never makes
    X = _pm1_field(torch, N_OBS, N_LAT * N_LON, n_pad, p_pad, gen,
                   torch.int8)
    Xb = X.to(torch.bfloat16)
    out = {}
    for name, Xk, kern, lib, lib_name in (
            ('int8', X, lambda: syrk(X, pm1=True),
             lambda: torch._int_mm(X, X.T), 'torch._int_mm(X, X.T)'),
            ('bf16', Xb, lambda: syrk(Xb),
             lambda: torch.mm(Xb, Xb.T, out_dtype=torch.float32),
             'torch.mm(X, X.T, out_dtype=torch.float32)')):
        ref = syrk_reference(Xk)
        err = float((kern() - ref).abs().max())
        t = _launch_ms(torch, kern, 20)
        plain_ms = _time_ms(torch, lambda: syrk_reference(Xk), 5)
        library_ms = _launch_ms(torch, lib, 20)['ms']
        b = _gram_bound(n_pad, p_pad, Xk.element_size(), name)
        out[name] = dict(max_abs_err=err, plain_ms=plain_ms,
                         library_ms=library_ms, **t, **b)
        print('syrk {} at {}: kernel {} (first wgmma version: {:.4f} ms) = '
              '{:.1f}% of its bound {:.4f} ms ({}); plain {:.3f} ms; '
              'library {} {:.4f} ms (kernel / library {:.3f})'.format(
                  name, (n_pad, p_pad), _spread(t), SYRK_PR3_MS[name],
                  100 * b['bound_ms'] / t['ms'], b['bound_ms'],
                  b['bound_by'], plain_ms, lib_name, library_ms,
                  t['ms'] / library_ms))
        if name == 'int8':
            out['sweep'] = syrk_sweep(torch, X, ref, 20)
        del ref
    return dict(out['int8'], bf16=out['bf16'], sweep=out['sweep'])


# band heights of K1's tile-order sweep (ops/syrk.py:tile_order; 1 is
# the row-major walk of the triangle, 11 the default on 132 SMs)
SYRK_BANDS = (1, 4, 8, 11, 12, 16)


def syrk_sweep(torch, X, ref, reps):
    """K1 int8 on the +-1 ``X`` in the tile order of each band height of
    SYRK_BANDS, with and without the wave barrier where the schedule has
    two whole waves or more: bit-equal to ``ref`` (``syrk_reference(X)``),
    a median of ``reps`` launches with its spread, the share of the
    bound, and the distinct row panels a whole wave reads in that
    order."""
    from xmca_tpu_torch.ops import syrk as k1
    n_pad, p_pad = X.shape
    sms = k1._sm_count(X.device.index)
    s = k1.schedule(n_pad, p_pad, 1, sms)
    b = _gram_bound(n_pad, p_pad, 1, 'int8')
    rows = []
    try:
        for band in SYRK_BANDS:
            for barrier in (True, False) if s.dp_tiles > s.grid else (True,):
                k1._BAND, k1._WAVE_BARRIER = band, barrier
                _check(torch.equal(k1.syrk(X, pm1=True), ref),
                       'syrk int8 in bands of {} (barrier {}) differs at {}'
                       .format(band, barrier, (n_pad, p_pad)))
                t = _launch_ms(torch, lambda: k1.syrk(X, pm1=True), reps)
                panels = k1.wave_panels(n_pad, sms, band) or [0]
                rows.append(dict(band=band, barrier=barrier,
                                 panels_max=max(panels),
                                 panels_mean=statistics.mean(panels), **t))
                print('syrk int8 at {} in bands of {} tile rows, {}: '
                      'bit-equal; {} = {:.1f}% of its bound {:.4f} ms; a '
                      'whole wave reads {} row panels at most, {:.2f} on '
                      'average'.format(
                          (n_pad, p_pad), band,
                          'wave barrier' if barrier else 'no barrier',
                          _spread(t), 100 * b['bound_ms'] / t['ms'],
                          b['bound_ms'], max(panels),
                          statistics.mean(panels)))
    finally:
        k1._BAND, k1._WAVE_BARRIER = None, True
    return rows


def check_sign_field(torch):
    from xmca_tpu_torch.ops.surrogate import (sign_field_sums,
                                              sign_field_sums_reference)
    from xmca_tpu_torch.ops.syrk import pad_to
    errs = []
    for n, p in ((N_OBS, N_LAT * N_LON), (200, 3000)):
        n_pad, p_pad = pad_to(n, p)
        X, s = sign_field_sums(123, n, p, n_pad, p_pad, 'cuda')
        Xr, sr = sign_field_sums_reference(123, n, p, n_pad, p_pad, 'cuda')
        torch.cuda.synchronize()
        errs.append(float((X.int() - Xr.int()).abs().max()))
        _check(torch.equal(X, Xr), 'sign field differs at {}'.format((n, p)))
        _check(torch.equal(s, sr), 'column sums differ at {}'.format((n, p)))
        _check(not X[n:].any() and not X[:, p:].any(), 'pads not zero')
        mean = float(X[:n, :p].float().mean())
        _check(abs(mean) < 5.0 / (n * p) ** 0.5,
               'field mean {:.3e} not ~0'.format(mean))
    n_pad, p_pad = pad_to(N_OBS, N_LAT * N_LON)
    ms = _time_ms(torch, lambda: sign_field_sums(
        5, N_OBS, N_LAT * N_LON, n_pad, p_pad, 'cuda'), 20)
    plain_ms = _time_ms(torch, lambda: sign_field_sums_reference(
        5, N_OBS, N_LAT * N_LON, n_pad, p_pad, 'cuda'), 3)
    # writes the int8 field and the int32 column sums; reads nothing; one
    # Philox call per 128 elements of the n true rows
    b = bound(nbytes=n_pad * p_pad + 4 * p_pad, calls=N_OBS * p_pad // 128)
    print('sign_field_sums bit-equal (field and sums) at {} and {}; '
          'kernel {:.4f} ms, plain {:.3f} ms, bound {:.4f} ms ({}; '
          'generation {:.4f} ms)'.format(
              (N_OBS, N_LAT * N_LON), (200, 3000), ms, plain_ms,
              b['bound_ms'], b['bound_by'], b['generation_ms']))
    return dict(max_abs_err=errs[0], ms=ms, plain_ms=plain_ms,
                library_ms=None, **b)


def check_surrogate_field(torch):
    from xmca_tpu_torch.ops.surrogate import (GEN_DISTS, surrogate_field,
                                              surrogate_field_reference)
    shapes = [(N_OBS, N_LAT * N_LON), (96, 400), (200, 3000), (1000, 4100)]
    for dist in GEN_DISTS:
        for n, p in shapes:
            X = surrogate_field(3, n, p, dist, 'cuda')
            ref = surrogate_field_reference(3, n, p, dist, 'cuda')
            torch.cuda.synchronize()
            _check(X.dtype == ref.dtype and torch.equal(X, ref),
                   'surrogate_field {} differs at {}'.format(dist, (n, p)))
    X = surrogate_field(3, N_OBS, N_LAT * N_LON, 'normal32', 'cuda').double()
    mean, var = float(X.mean()), float(X.var(unbiased=False))
    m4 = float((X ** 4).mean())
    del X
    print('surrogate_field bit-equal to plain for {} at {}; normal32 at '
          'full width: mean {:.2e}, var {:.6f}, 4th moment {:.4f} (3 - '
          '1/16 = 2.9375)'.format(GEN_DISTS, shapes, mean, var, m4))
    _check(abs(mean) < 5e-3 and abs(var - 1) < 5e-3
           and abs(m4 - (3 - 1 / 16)) < 5e-2, 'normal32 moments off')
    ms = _time_ms(torch, lambda: surrogate_field(
        5, N_OBS, N_LAT * N_LON, 'normal32', 'cuda'), 20)
    plain_ms = _time_ms(torch, lambda: surrogate_field_reference(
        5, N_OBS, N_LAT * N_LON, 'normal32', 'cuda'), 3)
    # writes the (n, p) bf16 field; reads nothing
    b = bound(nbytes=N_OBS * N_LAT * N_LON * 2,
              calls=_gen_calls(N_OBS, N_LAT * N_LON))
    print('surrogate_field normal32 at {}: kernel {:.4f} ms, plain {:.3f} '
          'ms, bound {:.4f} ms ({}; generation {:.4f} ms)'.format(
              (N_OBS, N_LAT * N_LON), ms, plain_ms, b['bound_ms'],
              b['bound_by'], b['generation_ms']))
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                **b)


def _gram_case(torch, seed, n, p, chunk_cols=None):
    """K3 at (n, p) against its plain versions: normal32 within 1e-4 of
    max|G| of the f64 plain version and of syrk(surrogate_field), mu, u
    and mu.mu within 1e-5; rademacher bit-equal; G exactly symmetric and
    the same bits on a second run.  Returns (normal32 G max abs error,
    G rel error vs plain, vs syrk)."""
    from xmca_tpu_torch.ops.surrogate import (surrogate_field,
                                              surrogate_gram,
                                              surrogate_gram_reference)
    from xmca_tpu_torch.ops.syrk import pad_to, syrk
    kw = {} if chunk_cols is None else {'chunk_cols': chunk_cols}
    G, mu, u, mumu = surrogate_gram(seed, n, p, 'normal32', 'cuda', **kw)
    again = surrogate_gram(seed, n, p, 'normal32', 'cuda', **kw)
    Gr, mur, ur, mumur = surrogate_gram_reference(seed, n, p, 'normal32',
                                                  'cuda')
    Xp = torch.zeros(pad_to(n, p), dtype=torch.bfloat16, device='cuda')
    Xp[:n, :p] = surrogate_field(seed, n, p, 'normal32', 'cuda')
    Gs = syrk(Xp)[:n, :n]
    del Xp
    torch.cuda.synchronize()
    scale = float(Gr.abs().max())
    err = float((G - Gr).abs().max())
    err_syrk = float((G - Gs).abs().max()) / scale
    err_mu = float((mu - mur).abs().max()) / float(mur.abs().max())
    err_u = float((u - ur).abs().max()) / float(ur.abs().max())
    err_mumu = abs(float(mumu - mumur)) / float(mumur)
    _check(err / scale <= 1e-4 and err_syrk <= 1e-4,
           'surrogate_gram G off at {}: {:.2e}, {:.2e}'.format(
               (n, p), err / scale, err_syrk))
    _check(max(err_mu, err_u, err_mumu) <= 1e-5,
           'surrogate_gram mu/u/mumu off at {}'.format((n, p)))
    _check(torch.equal(G, G.T), 'surrogate_gram G not symmetric at {}'
           .format((n, p)))
    _check(all(torch.equal(a, b) for a, b in zip((G, mu, u, mumu), again)),
           'surrogate_gram not the same bits twice at {}'.format((n, p)))
    del Gr, Gs, again
    for dist in ('rademacher', 'rademacher8'):
        Gi = surrogate_gram(seed, n, p, dist, 'cuda', **kw)[0]
        Gir = surrogate_gram_reference(seed, n, p, dist, 'cuda')[0]
        torch.cuda.synchronize()
        _check(torch.equal(Gi, Gir), 'surrogate_gram {} not bit-equal at {}'
               .format(dist, (n, p)))
    return err, err / scale, err_syrk, (err_mu, err_u, err_mumu)


def check_surrogate_gram(torch):
    from xmca_tpu_torch.ops.surrogate import (CHUNK_COLS, chunk_plan,
                                              surrogate_field,
                                              surrogate_gram,
                                              surrogate_gram_reference)
    from xmca_tpu_torch.ops.syrk import (TILE, pad_to, schedule, syrk,
                                         workspace_tiles)
    n, p = N_OBS, N_LAT * N_LON
    err, rel, rel_syrk, (e_mu, e_u, e_mumu) = _gram_case(torch, 8, n, p)
    print('surrogate_gram normal32 at {}: G rel err {:.2e} vs plain (f64), '
          '{:.2e} vs syrk(surrogate_field) (tol 1e-4); mu {:.2e}, u {:.2e}, '
          'mumu {:.2e} (tol 1e-5); symmetric, the same bits twice; '
          'rademacher and rademacher8 bit-equal'.format(
              (n, p), rel, rel_syrk, e_mu, e_u, e_mumu))
    # chunk edges: p < C, p = C, p = 2C + 1 (a one-column last chunk),
    # n = 130 (a padded second tile row) and n = 6000 (eight whole waves
    # of K1: its wave barrier in the accumulate mode)
    edges = [(n, 1000), (n, CHUNK_COLS), (n, 2 * CHUNK_COLS + 1),
             (130, 2 * CHUNK_COLS + 1), (6000, 2 * CHUNK_COLS + 1)]
    for shape in edges:
        _, r, rs, _ = _gram_case(torch, 12, *shape)
        print('surrogate_gram at chunk edge {} (C = {}): G rel err {:.2e} '
              'vs plain, {:.2e} vs syrk; symmetric, the same bits twice, '
              '+-1 bit-equal'.format(shape, CHUNK_COLS, r, rs))

    # device memory beyond what the caller holds: G, the column sums, the
    # slot and K1's split workspace (each a caching-allocator block, at
    # most 2 MiB over its size), and the n-vector u and the scalars
    n_pad = pad_to(n, p)[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    work = max(workspace_tiles(schedule(n_pad, w, 2, sms))
               for _, w in chunk_plan(p)) * TILE * TILE * 4
    parts = [n_pad * n_pad * 4, 4 * p, n_pad * CHUNK_COLS * 2, work]
    ws_bound = sum(-(-b // 2 ** 21) * 2 ** 21 for b in parts) + 2 ** 16
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = surrogate_gram(9, n, p, 'normal32', 'cuda')
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    del out
    print('surrogate_gram memory at {}: peak growth {:.1f} MB (G {:.1f} + '
          'colsum {:.1f} + slot {:.1f} + split workspace {:.1f} MB; bound '
          '{:.1f} MB; the stored bf16 field would take {:.1f} MB)'.format(
              (n, p), growth / 1e6, *(b / 1e6 for b in parts),
              ws_bound / 1e6, n * p * 2 / 1e6))
    _check(growth <= ws_bound and growth < n * p * 2 / 4,
           'surrogate_gram grew device memory by {} bytes'.format(growth))

    chunk_ms = {c: _time_ms(torch, lambda: surrogate_gram(
        9, n, p, 'normal32', 'cuda', chunk_cols=c), 10)
        for c in (4096, 8192, 16384)}
    # where one call's device time goes: generator, K1 and its split sums
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        surrogate_gram(9, n, p, 'normal32', 'cuda')
        torch.cuda.synchronize()
    print('surrogate_gram at {}, one call (torch.profiler): {}'.format(
        (n, p), '; '.join('{} x{} {:.1f} us'.format(
            _kernel_name(ev.key), ev.count, ev.self_device_time_total)
            for ev in prof.key_averages() if ev.self_device_time_total)))
    ms = chunk_ms[CHUNK_COLS]
    pm1_ms = _time_ms(torch, lambda: surrogate_gram(
        9, n, p, 'rademacher', 'cuda'), 10)
    plain_ms = _time_ms(torch, lambda: surrogate_gram_reference(
        9, n, p, 'normal32', 'cuda'), 3)
    Xp = torch.zeros(pad_to(n, p), dtype=torch.bfloat16, device='cuda')

    def composite():
        Xp[:n, :p] = surrogate_field(9, n, p, 'normal32', 'cuda')
        return syrk(Xp)
    comp_ms = _time_ms(torch, composite, 5)
    del Xp
    # the lower triangle of the (n, n) Gram of the generated (n, p) bf16
    # field; writes G, mu and u; generates the field once
    b = bound(n * (n + 1) / 2 * p * 2, 'bf16', 4 * (n * n + p + n),
              _gen_calls(n, p))
    print('surrogate_gram at {}: kernel {:.4f} ms (C = {}; {}), '
          'rademacher (int8) {:.4f} ms; plain (f64 matmul) {:.3f} ms; '
          'surrogate_field + pad copy + syrk bf16 {:.4f} ms; bound {:.4f} '
          'ms ({}; generation {:.4f} ms)'.format(
              (n, p), ms, CHUNK_COLS, ', '.join(
                  'C = {}: {:.4f} ms'.format(c, t)
                  for c, t in chunk_ms.items()),
              pm1_ms, plain_ms, comp_ms, b['bound_ms'], b['bound_by'],
              b['generation_ms']))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                field_plus_syrk_ms=comp_ms, rademacher_ms=pm1_ms,
                chunk_ms={str(c): t for c, t in chunk_ms.items()},
                memory_growth_mb=growth / 1e6, **b)


# the monthly deployment's SES sweeps: 480 months of the [field | flipped
# field] block of ERA5's 0.25-deg grid (2 x 1038240 series)
SES_T, SES_P = 480, 2 * 721 * 1440


def kernel_resources(name):
    """``{entry function: (registers, spill store bytes, spill load
    bytes)}`` of each kernel whose mangled name holds ``name``, from this
    process's -Xptxas -v log (empty when the library was not rebuilt
    here)."""
    import re
    from xmca_tpu_torch.ops import _build
    out, fn, spills = {}, None, (0, 0)
    for line in _build.build_log().splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            fn = m.group(1) if name in m.group(1) else None
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and fn:
            out[fn] = (int(m.group(1)),) + spills
    return out


def check_surrogate_project(torch):
    from xmca_tpu_torch.ops.surrogate import (surrogate_field,
                                              surrogate_project,
                                              surrogate_project_reference)
    n, p, m = N_OBS, N_LAT * N_LON, 2 * N_ROT
    gen = torch.Generator(device='cuda').manual_seed(4)
    S = torch.randn((n, m), generator=gen, device='cuda')
    P = surrogate_project(10, S, n, p, 'normal32', 'cuda')
    again = surrogate_project(10, S, n, p, 'normal32', 'cuda')
    ref = surrogate_project_reference(10, S, n, p, 'normal32', 'cuda')
    torch.cuda.synchronize()
    err = float((P - ref).abs().max())
    rel = err / float(ref.abs().max())
    _check(rel <= 1e-5, 'surrogate_project rel err {:.2e} > 1e-5'
           .format(rel))
    _check(torch.equal(P, again), 'surrogate_project not the same bits '
           'twice')
    regs = {k: v[0] for k, v in kernel_resources('project_kernel').items()}
    _check(all(r <= 96 for r in regs.values()),
           'surrogate_project kernels above 96 registers: {}'.format(regs))
    ms = _time_ms(torch, lambda: surrogate_project(
        10, S, n, p, 'normal32', 'cuda'), 20)
    plain_ms = _time_ms(torch, lambda: surrogate_project_reference(
        10, S, n, p, 'normal32', 'cuda'), 3)
    Sb = S.to(torch.bfloat16)
    # the yardstick the port never calls: store the field, then one
    # library product
    comp_ms = _time_ms(torch, lambda: torch.mm(
        surrogate_field(10, n, p, 'normal32', 'cuda').T, Sb,
        out_dtype=torch.float32), 10)
    # P = X^T S: 2 n p m operations on bf16 values (the generated field
    # and S rounded to bf16); reads S, writes P; generates the field once
    b = bound(2.0 * n * p * m, 'bf16', 4 * (n * m + p * m),
              _gen_calls(n, p))
    print('surrogate_project at {} x m={}: rel err {:.2e} (tol 1e-5), the '
          'same bits twice; registers {} (max 96); kernel {:.4f} ms, plain '
          '(f64 matmul) {:.3f} ms, surrogate_field + torch.mm(X.T, '
          'S.bfloat16(), out_dtype=torch.float32) {:.4f} ms, bound {:.4f} '
          'ms ({}; generation {:.4f} ms)'.format(
              (n, p), m, rel, sorted(regs.values()) or 'not rebuilt here',
              ms, plain_ms, comp_ms, b['bound_ms'], b['bound_by'],
              b['generation_ms']))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                field_plus_mm_ms=comp_ms, **b)


def check_ses(torch):
    """The SES sweep kernel at the monthly deployment's (480, 2076480):
    the coarse 33-point sweep and the 17-point refinement against the
    plain loop on the card (the same chosen points, alpha and ``l_T`` bit
    for bit, SSE and every point's ``l_T`` within 1e-12 relative), each
    timed beside its least time (``perfbench/roofline_ext.py``) and the
    plain loop's; its registers (at most 128) and spills (none) from the
    build log."""
    import numpy as np
    from perfbench.roofline_ext import ses_least_s
    from xmca_tpu_torch.core.theta import ALPHA_CLIP, _ses_sweep
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.ops.ses import ses_sweep
    T, p = SES_T, SES_P
    gen = torch.Generator(device='cuda').manual_seed(20)
    y = torch.randn((T, p), generator=gen, device='cuda')
    torch.cumsum(y.mul_(0.3), dim=0, out=y)        # persistent series
    y[:, :1024] = y[:1, :1024]                     # and constant ones
    coarse = torch.as_tensor(np.linspace(0.02, 0.98, 33), device='cuda')
    spacing = 0.96 / 32
    offsets = torch.as_tensor(np.linspace(-spacing, spacing, 17),
                              device='cuda')
    _build.reset_launch_counts()
    y64 = y.double()
    out, best = {}, None
    for name in ('coarse', 'refine'):
        if best is None:
            grid, args = coarse[:, None], (y, coarse)
        else:
            grid = torch.clamp(coarse[best][None, :] + offsets[:, None],
                               *ALPHA_CLIP)
            args = (y, coarse, best, offsets, ALPHA_CLIP)
        k_best, k_alpha, k_level, k_sse, k_lT = ses_sweep(*args, states=True)
        sse, lT = _ses_sweep(y64, grid)
        want = torch.argmin(sse, dim=0)
        torch.cuda.synchronize()
        rel = max(float(((k - r).abs() / r.abs().clamp_min(1e-300)).max())
                  for k, r in ((k_sse, sse), (k_lT, lT)))
        _check(torch.equal(k_best, want), 'ses_sweep {}: chosen points '
               'differ from the plain loop'.format(name))
        _check(torch.equal(k_alpha, grid.expand_as(sse).gather(
            0, want[None])[0]) and torch.equal(
                k_level, lT.gather(0, want[None])[0]),
            'ses_sweep {}: alpha or l_T differ from the plain loop'.format(
                name))
        _check(rel <= 1e-12, 'ses_sweep {}: SSE or l_T rel err {:.2e} > '
               '1e-12'.format(name, rel))
        del k_sse, k_lT, sse, lT
        G = grid.shape[0]
        ms = _time_ms(torch, lambda: ses_sweep(*args), 5)
        plain_ms = _time_ms(torch, lambda: _ses_sweep(y64, grid), 1)
        least_ms = 1e3 * ses_least_s(T, G, p)
        out[name] = dict(grid=G, ms=ms, plain_ms=plain_ms, bound_ms=least_ms,
                         share=least_ms / ms, max_rel_err=rel)
        print('ses_sweep {} (G = {}) at {}: chosen points, alpha and l_T '
              'bit-equal to the plain loop, SSE and l_T rel err {:.1e} (tol '
              '1e-12); kernel {:.3f} ms, least time {:.3f} ms ({:.1f}%), '
              'plain loop {:.1f} ms'.format(name, G, (T, p), rel, ms,
                                            least_ms, 100 * least_ms / ms,
                                            plain_ms))
        best = want
    import re
    res = {}
    for fn, v in kernel_resources('ses_kernel').items():
        res[re.search(r'ses_kernelI(\w)E', fn).group(1)] = v
    print('ses_sweep kernels (registers, spill store / load bytes; f: '
          'float32 series, d: float64): {}'.format(res or 'not rebuilt here'))
    _check(all(v[0] <= 128 and v[1] == v[2] == 0 for v in res.values()),
           'ses_sweep kernels above 128 registers or spilling: {}'.format(
               res))
    # this check's own launches; the public path's are extend_path's
    out['check_launches'] = _build.launch_counts().get('ses_sweep', 0)
    return out


# the +-1 back-projection's shapes (n_obs, p, m): ERA5's 0.25-deg grid
# (the benchmark's Rule-N cell) complexified and real, the main path's
# width, the 14610-step record's and the 103.7 GB chunk-backed record's
PM1_SHAPES = ((2000, 721 * 1440, 20), (2000, 721 * 1440, 10),
              (N_OBS, N_LAT * N_LON, 20), (N_LONG, N_LAT * N_LON, 20),
              (2000, 6480000, 20))
# f64 bytes of one column block of the exact back-projection
PM1_REF_BYTES = 1 << 31


def _pm1_errors(torch, X, S_pad, p, outs):
    """Rel Frobenius distance of each of ``outs`` ((p, m) tensors) from
    the f64 product ``(X^T S_pad)[:p]``, summed in column blocks of at
    most PM1_REF_BYTES."""
    S64 = S_pad.double()
    cols = max(1, PM1_REF_BYTES // (8 * X.shape[0]))
    diff, norm = [0.0] * len(outs), 0.0
    for c0 in range(0, p, cols):
        ref = X[:, c0:min(c0 + cols, p)].double().T @ S64
        norm += float(torch.sum(ref * ref))
        for k, out in enumerate(outs):
            d = out[c0:c0 + ref.shape[0]].double() - ref
            diff[k] += float(torch.sum(d * d))
        del ref
    return [(d / norm) ** 0.5 for d in diff]


def check_pm1_project(torch):
    """The +-1 back-projection kernel at PM1_SHAPES on padded fields drawn
    by K2: within PROJECT_TOL of the f64 product (rel Frobenius), the same
    bits on a second launch, one launch a call (m = 20 and 10); timed (a
    median of 10 per-launch event pairs) beside its bound (multiply-adds
    at 67 TFLOP/s f32 or bytes at 3.35 TB/s, the larger), the plain
    blocked version (``core.fastpath._pm1_project_plain``: 1 GiB f32
    column blocks, each one cuBLAS product) and the yardstick the port
    never calls, ``torch.mm(X.float().T, S_pad)`` (not measured where the
    f32 copy does not fit beside the field).  Registers and spills from
    the build log."""
    from xmca_tpu_torch.core.fastpath import _pm1_project_plain
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.ops.project import pm1_project
    from xmca_tpu_torch.ops.surrogate import sign_field_sums
    from xmca_tpu_torch.ops.syrk import pad_to
    res = kernel_resources('pm1_project_kernel')
    print('pm1_project kernels (registers, spill store / load bytes): {}'
          .format(res or 'not rebuilt here'))
    gen = torch.Generator(device='cuda').manual_seed(22)
    rows = []
    for n, p, m in PM1_SHAPES:
        n_pad, p_pad = pad_to(n, p)
        X, _ = sign_field_sums(22 + n + m, n, p, n_pad, p_pad, 'cuda')
        S_pad = torch.zeros((n_pad, m), device='cuda')
        S_pad[:n] = torch.randn((n, m), generator=gen, device='cuda')
        _build.reset_launch_counts()
        got = pm1_project(X, S_pad, p)
        again = pm1_project(X, S_pad, p)
        launches = _build.launch_counts().get('pm1_project', 0)
        plain = _pm1_project_plain(X, S_pad, p)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        err, plain_err = _pm1_errors(torch, X, S_pad, p, (got, plain))
        del again
        t = _launch_ms(torch, lambda: pm1_project(X, S_pad, p), 10)
        plain_ms = _time_ms(torch, lambda: _pm1_project_plain(X, S_pad, p),
                            3)
        del plain
        torch.cuda.empty_cache()
        if torch.cuda.mem_get_info()[0] > 1.2 * 4 * n_pad * p_pad:
            library_ms = _time_ms(torch, lambda: torch.mm(
                X.float().T, S_pad), 3)
        else:
            library_ms = None
        b = bound(2.0 * n_pad * p * m, 'f32',
                  n_pad * p + 4 * (p * m + n_pad * m))
        rows.append(dict(shape=(n_pad, p_pad), p=p, m=m, rel_err=err,
                         plain_rel_err=plain_err, same_bits=same,
                         launches=launches, plain_ms=plain_ms,
                         library_ms=library_ms, share=b['bound_ms'] / t['ms'],
                         **t, **b))
        print('pm1_project at {} (p {}, m {}): rel Frobenius vs f64 {:.2e} '
              '(tol {:g}; plain {:.2e}), the same bits twice {}, {} '
              'launches for two calls; kernel {}, bound {:.4f} ms ({}; '
              '{:.1f}%), plain blocked {:.3f} ms, torch.mm(X.float().T, '
              'S_pad) {}'.format(
                  (n_pad, p_pad), p, m, err, PROJECT_TOL, plain_err, same,
                  launches, _spread(t), b['bound_ms'], b['bound_by'],
                  100 * b['bound_ms'] / t['ms'], plain_ms,
                  'not measured (memory)' if library_ms is None else
                  '{:.3f} ms'.format(library_ms)))
        _check(err <= PROJECT_TOL and same and launches == 2,
               'pm1_project at {} m {}: rel {:.2e}, same bits {}, launches '
               '{}'.format((n_pad, p_pad), m, err, same, launches))
        del X, S_pad, got
        torch.cuda.empty_cache()
    return {'shapes': rows, 'resources': res}


def gen_runs(torch, fn, n_obs, n_vars, n_runs, device, **kw):
    """``n_runs`` Rule-N surrogate solves with the run seeds and start
    blocks of ``stats.significance``; returns (variances of the kept
    runs (numpy), totals, number kept, seconds per run)."""
    import numpy as np
    from xmca_tpu_torch.core.fastpath import hilbert_operator, start_block
    from xmca_tpu_torch.stats.significance import run_seeds
    H = hilbert_operator(n_obs, torch.float32, device)
    out, totals = [], []
    t0 = time.perf_counter()
    for s in run_seeds(SEED, n_runs):
        gen = torch.Generator(device='cpu').manual_seed(s)
        omega = start_block(n_obs, kw['n_rot'], torch.complex64,
                            gen).to(device)
        var, total, conv, _ = fn(s, omega, n_obs, n_vars, H=H,
                                 complexify=True, **kw)
        if conv:
            out.append(var)
            totals.append(total)
    if device == 'cuda':
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_runs
    if not out:
        return np.zeros((0, kw['n_rot'])), np.zeros(0), 0, wall
    return (torch.stack(out).cpu().numpy(), torch.stack(totals).cpu().numpy(),
            len(out), wall)


def profile_runs(torch, fn, n_vars, n_runs):
    """Device kernel time per run of ``fn`` (torch.profiler's CUDA
    activity over ``n_runs`` runs) and the kernels that take most of it:
    (ms per run, [(name, calls per run, ms per run), ...])."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gen_runs(torch, fn, N_OBS, n_vars, n_runs, 'cuda', rotated=True,
                 n_rot=N_ROT, **ENSEMBLE)
    rows = [(ev.key, ev.count / n_runs,
             ev.self_device_time_total / 1e3 / n_runs)
            for ev in prof.key_averages() if ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return sum(r[2] for r in rows), rows[:6]


def gen_path(torch):
    """The generated surrogate at full width against the +-1 one."""
    import numpy as np
    from xmca_tpu_torch.core.fastpath import (fast_surrogate_variance_gen,
                                              fast_surrogate_variance_tri)
    from xmca_tpu_torch.ops import _build
    n_vars = (N_LAT * N_LON, N_LAT * N_LON)
    _build.reset_launch_counts()
    var_g, _, kept, wall_g = gen_runs(
        torch, fast_surrogate_variance_gen, N_OBS, n_vars, N_GEN, 'cuda',
        rotated=True, n_rot=N_ROT, **ENSEMBLE)
    launches = _build.launch_counts()
    var_t, _, kept_t, wall_t = gen_runs(
        torch, fast_surrogate_variance_tri, N_OBS, n_vars, N_GEN, 'cuda',
        rotated=True, n_rot=N_ROT, **ENSEMBLE)
    g, t = np.median(var_g[:, 0]), np.median(var_t[:, 0])
    spread = var_g[:, 0].std() + var_t[:, 0].std()
    print('generated Rule-N at {} x 2 x {}, N={}: {:.4f} s/run ({} kept); '
          'the +-1 path over the same seeds {:.4f} s/run ({} kept); '
          'launches {}'.format(N_OBS, n_vars[0], N_GEN, wall_g, kept,
                               wall_t, kept_t, launches))
    print('leading null variance median: generated {:.2f}, +-1 {:.2f}, '
          'combined spread {:.2f} (tol 2x)'.format(g, t, spread))
    _check(launches.get('surrogate_gram', 0) == 2 * N_GEN
           and launches.get('surrogate_project', 0) == 2 * N_GEN,
           'generated path launched {}'.format(launches))
    _check('surrogate_field' not in launches,
           'the generated path stored a field')
    _check(kept >= 0.9 * N_GEN, 'kept {} of {} runs'.format(kept, N_GEN))
    _check(np.isfinite(var_g).all(), 'non-finite generated variances')
    _check(abs(g - t) < 2.0 * spread,
           'generated and +-1 nulls disagree: {:.2f} vs {:.2f}'.format(g, t))
    for name, fn, wall in (('generated', fast_surrogate_variance_gen, wall_g),
                           ('+-1', fast_surrogate_variance_tri, wall_t)):
        dev_ms, top = profile_runs(torch, fn, n_vars, 4)
        print('{} run, torch.profiler over 4 runs: device kernel time '
              '{:.2f} ms/run ({:.0f}% of its {:.1f} ms unprofiled wall); '
              'top: {}'.format(name, dev_ms, 100 * dev_ms / (1e3 * wall),
                               1e3 * wall, '; '.join(
                                   '{} x{:g} {:.3f} ms'.format(
                                       _kernel_name(k), c, ms)
                                   for k, c, ms in top)))
    return launches


def gen_small(torch):
    """The generated surrogate small, on the card (kernels) and on the
    CPU (plain versions): the same bits on both sides.  The rotation
    runs to the f32 floor (tol 1e-8 clamps to 100 eps), where its fixed
    point is defined; at 1e-4 it stops on a plateau that f32 differences
    in the loadings move."""
    import numpy as np
    from xmca_tpu_torch.core.fastpath import fast_surrogate_variance_gen
    n_obs, n_vars = 256, (512, 384)
    res = {}
    for device in ('cuda', 'cpu'):
        for rotated in (True, False):
            kw = dict(ENSEMBLE, tol=1e-8) if rotated else ENSEMBLE
            res[device, rotated] = gen_runs(
                torch, fast_surrogate_variance_gen, n_obs, n_vars, 4,
                device, rotated=rotated, n_rot=4, **kw)
    for rotated in (True, False):
        _check(res['cuda', rotated][2] == 4 and res['cpu', rotated][2] == 4,
               'small generated path dropped a run')
    var_err = np.max(np.abs(res['cuda', True][0] / res['cpu', True][0] - 1))
    tot_err = np.max(np.abs(res['cuda', True][1] / res['cpu', True][1] - 1))
    sv_err = np.max(np.abs(res['cuda', False][0] / res['cpu', False][0] - 1))
    print('small generated path card vs CPU at {} x {}: rotated variance '
          'rel {:.2e}, totals rel {:.2e} (tol 1e-3); unrotated spectrum rel '
          '{:.2e} (tol 1e-4)'.format(n_obs, n_vars, var_err, tot_err,
                                      sv_err))
    _check(var_err <= 1e-3 and tot_err <= 1e-3 and sv_err <= 1e-4,
           'card and CPU disagree on the small generated path')


def make_fields(n_obs, n_lat, n_lon, seed0=1):
    """Two synthetic f32 fields with red spectra, as bench.py makes them."""
    import numpy as np
    from xmca_tpu_torch.xarray import DataArray
    t = np.arange(n_obs, dtype=np.float32)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 9)[None, :]
                   / n_obs).astype(np.float32)
    p = n_lat * n_lon
    coords = {'time': t,
              'lat': np.linspace(-60, 60, n_lat, dtype=np.float32),
              'lon': np.linspace(0, 359, n_lon, dtype=np.float32)}
    out = []
    for seed in (seed0, seed0 + 1):
        r = np.random.default_rng(seed)
        data = modes @ r.standard_normal((8, p), dtype=np.float32)
        data += r.standard_normal((n_obs, p), dtype=np.float32)
        out.append(DataArray(data.reshape(n_obs, n_lat, n_lon),
                             dims=('time', 'lat', 'lon'), coords=coords))
    return out


def _timed(torch, walls, name, fn, device='cuda'):
    """``fn()``; its host seconds, ending in a device synchronize, go to
    ``walls[name]``."""
    t0 = time.perf_counter()
    out = fn()
    if device == 'cuda':
        torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    return out


def workload(torch, left, right, device, n_runs, n_rot, walls=None):
    """The main path; ``walls`` collects host seconds per stage (each
    stage ends in a device synchronize)."""
    from xmca_tpu_torch.xarray import xMCA
    walls = {} if walls is None else walls

    def stage(name, fn):
        return _timed(torch, walls, name, fn, device)

    m = stage('ingest', lambda: xMCA(left, right, device=device))

    def solve():
        m.set_solver(truncate=n_rot)
        m.normalize()
        m.apply_coslat()
        m.solve(complexify=True)
    stage('solve', solve)
    stage('rotate', lambda: m.rotate(n_rot))
    null = stage('rule_n', lambda: m.rule_n(n_runs, seed=SEED))
    return m, null


def _vals(x):
    import numpy as np
    return np.asarray(getattr(x, 'values', x))


def _rel(got, ref):
    """max |got - ref| over max |ref|."""
    import numpy as np
    got, ref = _vals(got), _vals(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _align(ours, ref):
    """``ours`` times the unit factor per mode (last axis) that best
    matches ``ref``: singular vectors are unique only up to one."""
    import numpy as np
    ours, ref = _vals(ours), _vals(ref)
    ip = np.sum(np.conj(ours.reshape(-1, ours.shape[-1]))
                * ref.reshape(-1, ref.shape[-1]), axis=0)
    return ours * (ip / np.where(np.abs(ip) > 0, np.abs(ip), 1))


def result_getters(torch, m, n, walls, device='cuda'):
    """Every result getter of a solved, rotated model, each timed into
    ``walls``; the first N_PREDICT steps of the original-scale fields are
    what ``predict`` projects."""
    calls = (
        ('eofs', lambda: m.eofs(n)),
        ('pcs', lambda: m.pcs(n)),
        ('spatial_amplitude', lambda: m.spatial_amplitude(n)),
        ('spatial_phase', lambda: m.spatial_phase(n)),
        ('temporal_amplitude', lambda: m.temporal_amplitude(n)),
        ('temporal_phase', lambda: m.temporal_phase(n)),
        ('homogeneous_patterns', lambda: m.homogeneous_patterns(n)),
        ('heterogeneous_patterns', lambda: m.heterogeneous_patterns(n)),
        ('reconstructed_fields',
         lambda: m.reconstructed_fields(slice(1, n))),
        ('fields', lambda: m.fields(original_scale=True)),
        ('scf', m.scf),
        ('rotation_matrix', lambda: m.rotation_matrix(True)),
        ('correlation_matrix', m.correlation_matrix),
    )
    out = {name: _timed(torch, walls, name, fn, device)
           for name, fn in calls}
    new = {k: f.isel(time=slice(0, N_PREDICT))
           for k, f in out['fields'].items()}
    out['predict'] = _timed(torch, walls, 'predict', lambda: m.predict(
        left=new['left'], right=new['right']), device)
    return out


def check_results(out, n, n_obs, grid):
    """Shapes and finiteness of every getter's result (the synthetic
    fields keep every column); returns predict's error against the rows
    of pcs it projects (the same steps of the same complexified data)."""
    import numpy as np
    spatial, temporal = tuple(grid) + (n,), (n_obs, n)
    shapes = {'eofs': spatial, 'pcs': temporal,
              'spatial_amplitude': spatial, 'spatial_phase': spatial,
              'temporal_amplitude': temporal, 'temporal_phase': temporal,
              'reconstructed_fields': (n_obs,) + tuple(grid),
              'fields': (n_obs,) + tuple(grid), 'predict': (N_PREDICT, n)}
    for name, shape in shapes.items():
        for k, v in out[name].items():
            a = _vals(v)
            _check(a.shape == shape and np.isfinite(a).all(),
                   '{} {}: shape {} (expected {}) or non-finite values'
                   .format(name, k, a.shape, shape))
    for name in ('homogeneous_patterns', 'heterogeneous_patterns'):
        maps, pvals = out[name]
        for k in maps:
            r, p = _vals(maps[k]), _vals(pvals[k])
            _check(r.shape == spatial == p.shape and np.isfinite(r).all()
                   and np.abs(r).max() <= 1 + 1e-5
                   and ((p >= 0) & (p <= 1)).all(),
                   '{} {}: bad correlations or p-values'.format(name, k))
    scf = _vals(out['scf'])
    _check(scf.shape == (n,) and np.isfinite(scf).all(), 'bad scf')
    for name in ('rotation_matrix', 'correlation_matrix'):
        _check(out[name].shape == (n, n) and np.isfinite(out[name]).all(),
               'bad ' + name)
    return max(_rel(out['predict'][k], _vals(out['pcs'][k])[:N_PREDICT])
               for k in out['pcs'])


def _print_walls(label, walls):
    print('{}: {}'.format(label, ', '.join(
        '{} {:.4f} s'.format(k, v) for k, v in walls.items())))


def result_path(torch, m):
    """The result getters on the main path's truncated, rotated model at
    full width."""
    import numpy as np
    walls = {}
    _check(m._complexify_pending,
           'rotate or rule_n materialized the complex fields')
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _timed(torch, walls, 'eofs before Z', lambda: m.eofs(N_ROT))
    _check(m._complexify_pending, 'eofs materialized the complex fields')
    _timed(torch, walls, 'Z materialization', m._ensure_complex_fields)
    _check(not m._complexify_pending and m._fields['left'].is_complex(),
           'Z was not materialized')
    out = result_getters(torch, m, N_ROT, walls)
    pred_err = check_results(out, N_ROT, N_OBS, (N_LAT, N_LON))
    peak = torch.cuda.max_memory_allocated()
    # reconstructions of modes 1-5 and 1-10 against the scaled field
    scaled = {k: _vals(f).real
              for k, f in m.fields(original_scale=False).items()}
    residual = {}
    for modes in (5, N_ROT):
        rec = m.reconstructed_fields(slice(1, modes), original_scale=False)
        residual[modes] = max(
            float(np.linalg.norm((_vals(rec[k]) - x).ravel())
                  / np.linalg.norm(x.ravel())) for k, x in scaled.items())
    _print_walls('result_path at {} x 2 x {} (truncated model, rotate({}))'
                 .format(N_OBS, N_LAT * N_LON, N_ROT), walls)
    print('result_path: peak device memory {:.2f} GB ({:.2f} GB resident '
          'before); predict(fields(original_scale=True) first {} steps) vs '
          'pcs rows: rel {:.2e} (tol 1e-4); reconstruction residual modes '
          '1-5 {:.4f}, 1-{} {:.4f} (must fall, below 1)'.format(
              peak / 1e9, base / 1e9, N_PREDICT, pred_err, residual[5],
              N_ROT, residual[N_ROT]))
    _check(pred_err <= 1e-4, 'predict differs from pcs: {:.2e}'
           .format(pred_err))
    _check(residual[N_ROT] < residual[5] < 1,
           'reconstruction residuals {}'.format(residual))


def dense_stages(torch, X):
    """The dense complex solve's stages one at a time (warm) on the
    preprocessed real fields ``X``, with the algebra of
    ``core.solver.solve_mca`` and ``field_decomposition``'s p > n branch;
    returns the walls and the spectrum."""
    from xmca_tpu_torch.core import preprocess as pre
    from xmca_tpu_torch.core.linalg import kernel_svd, safe_reciprocal
    from xmca_tpu_torch.core.solver import _kernel
    walls = {}
    keys = ('left', 'right')

    def each(fn):
        return {k: fn(k) for k in keys}

    Z = _timed(torch, walls, 'complexify',
               lambda: each(lambda k: pre.complexify(X[k])))
    G = _timed(torch, walls, 'Grams', lambda: each(lambda k: Z[k] @ Z[k].mH))
    eig = _timed(torch, walls, 'eigh',
                 lambda: each(lambda k: torch.linalg.eigh(G[k])))
    del G

    def recover(k):
        w, Q = (torch.flip(a, (-1,)) for a in eig[k])
        L = torch.sqrt(torch.clamp(w, min=0.0))
        return Q, L, Z[k].mH @ (Q * safe_reciprocal(L))
    KLM = _timed(torch, walls, 'M', lambda: each(recover))
    dof = Z['left'].shape[0] - 1
    U, s, Vh = _timed(torch, walls, 'kernel + kernel SVD', lambda: kernel_svd(
        _kernel(KLM['left'][0], KLM['left'][1], KLM['right'][0],
                KLM['right'][1], dof)))
    _timed(torch, walls, 'back-projection',
           lambda: (KLM['left'][2] @ U, KLM['right'][2] @ Vh.mH))
    return walls, s.cpu().numpy()


def dense_path(torch, left, right, m):
    """The same fields through the exact dense solve at full width, its
    getters and Rule-N, held against the truncated model ``m``."""
    import numpy as np
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.xarray import xMCA
    walls = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    d = _timed(torch, walls, 'ingest',
               lambda: xMCA(left, right, device='cuda'))

    def prepare():
        d.normalize()
        d.apply_coslat()
    _timed(torch, walls, 'normalize + apply_coslat', prepare)
    # the stage-by-stage rerun below starts from the same real fields
    X = {k: f.clone() for k, f in d._fields.items()}
    copy_bytes = sum(f.numel() * f.element_size() for f in X.values())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _timed(torch, walls, 'solve', lambda: d.solve(complexify=True))
    solve_growth = torch.cuda.max_memory_allocated() - before
    resident = torch.cuda.memory_allocated() - base - copy_bytes
    _timed(torch, walls, 'rotate', lambda: d.rotate(N_ROT))
    eofs = _timed(torch, walls, 'eofs unrotated',
                  lambda: d.eofs(N_ROT, rotated=False))
    out = result_getters(torch, d, N_ROT, walls)
    null = _timed(torch, walls, 'rule_n',
                  lambda: d.rule_n(N_DENSE_RUNS, seed=SEED))
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    pred_err = check_results(out, N_ROT, N_OBS, (N_LAT, N_LON))

    # the truncated solve resolves mode i when its subspace iteration has
    # damped the rest by (s_kk / s_i)^(2 iters) (kk = k + 16 columns)
    s_all = d.singular_values().values
    kk, iters = N_ROT + 16, m._subspace_iters
    resolved = (s_all[kk] / s_all[:N_ROT]) ** (2 * iters) <= 1e-6
    s_m = m.singular_values(N_ROT).values
    sv_err = np.abs(s_all[:N_ROT] / s_m - 1)
    # the truncated solve's jitter perturbs its kernel by about its
    # largest singular-value offset on the resolved modes; an EOF then
    # moves by up to that over its gap to the nearest singular value
    # (Davis-Kahan), which for modes ~1% apart exceeds 1e-3
    eps_abs = np.abs(s_all[:N_ROT] - s_m)[resolved].max()
    below = s_all[:N_ROT] - s_all[1:N_ROT + 1]
    gap = np.minimum(below, np.r_[np.inf, below[:-1]])
    eof_tol = np.maximum(1e-3, eps_abs / gap)
    # the dense solve alone: C v_r = s v_l and C^H v_l = s v_r for
    # C = Zl^H Zr / dof, relative to ||C|| = s_1, on every mode
    Z, V = d._fields, {k: v[:, :N_ROT] for k, v in d._V.items()}
    s10 = torch.as_tensor(s_all[:N_ROT], device='cuda')
    svd_res = np.maximum(*(
        torch.linalg.norm(Z[a].mH @ (Z[b] @ V[b]) / (N_OBS - 1)
                          - V[a] * s10, dim=0).cpu().numpy()
        for a, b in (('left', 'right'), ('right', 'left')))) / s_all[0]
    eofs_m = m.eofs(N_ROT, rotated=False)
    eof_err = np.array([max(
        float(np.abs(_align(eofs[k].values[..., i:i + 1],
                            eofs_m[k].values[..., i:i + 1])
                     - eofs_m[k].values[..., i:i + 1]).max()
              / np.abs(eofs_m[k].values[..., i]).max())
        for k in ('left', 'right')) for i in range(N_ROT)])
    totals = {key: d._analysis[key] / m._analysis[key] - 1
              for key in ('total_covariance', 'total_squared_covariance')}
    null = np.asarray(null)
    stage_walls, s_stages = dense_stages(torch, X)
    del X
    stage_err = _rel(s_stages, s_all)
    _print_walls('dense_path at {} x 2 x {} (cold)'.format(
        N_OBS, N_LAT * N_LON), walls)
    _print_walls('dense solve stage by stage (warm; spectrum rel {:.1e} '
                 "of the model's)".format(stage_err), stage_walls)
    print('dense_path: device memory ({:.2f} GB resident before): the '
          'solve grew it by at most {:.2f} GB above its input; the solved '
          'model holds {:.2f} GB; peak of the path {:.2f} GB above the '
          'start (with the {:.2f} GB copy of the real fields); launches {}; '
          'rule_n kept {} of {} runs; predict vs pcs rel {:.2e}'.format(
              base / 1e9, solve_growth / 1e9, resident / 1e9, peak / 1e9,
              copy_bytes / 1e9, launches, null.shape[1], N_DENSE_RUNS,
              pred_err))
    print('dense solve, modes 1-{}: singular-vector residual '
          '|C v - s u| / s_1 {} (tol 1e-4)'.format(
              N_ROT, np.array2string(svd_res, precision=2)))
    print('dense vs truncated, modes 1-{}: singular values rel {}; EOF '
          '(unrotated, aligned) rel {}, tol max(1e-3, {:.3g} / gap) {}; '
          'resolved by the truncated solve (damping <= 1e-6): {} (checked '
          'there; singular values tol 1e-4); totals rel cov {:.2e}, '
          'squared {:.2e}'.format(
              N_ROT, np.array2string(sv_err, precision=2),
              np.array2string(eof_err, precision=2), eps_abs,
              np.array2string(eof_tol, precision=2),
              np.nonzero(resolved)[0] + 1, totals['total_covariance'],
              totals['total_squared_covariance']))
    _check((svd_res <= 1e-4).all(), 'the dense solve is not an SVD')
    _check(resolved.sum() >= 8, 'the truncated solve resolves {} modes'
           .format(resolved.sum()))
    _check((sv_err[resolved] <= 1e-4).all(),
           'dense and truncated singular values differ')
    _check((eof_err <= eof_tol)[resolved].all(),
           'dense and truncated EOFs differ')
    _check(pred_err <= 1e-4, 'dense predict differs from pcs')
    _check(stage_err <= 1e-4, 'the stage-by-stage solve differs from the '
           "model's: {:.2e}".format(stage_err))
    _launch_gate('dense path', launches, N_DENSE_RUNS)
    _check(null.shape == (N_ROT, null.shape[1])
           and null.shape[1] >= 0.9 * N_DENSE_RUNS
           and np.isfinite(null).all(),
           'dense Rule-N kept {} of {} runs'.format(null.shape[1],
                                                   N_DENSE_RUNS))


# carried state: the same solution on both devices, so every getter is
# held at f32 roundoff; own solves: independent, compared after
# per-mode alignment where the result carries a mode's unit factor
SMALL_TOL = {'carried': 1e-4, 'own': 1e-3}
_PHASE_FREE = ('spatial_amplitude', 'temporal_amplitude',
               'reconstructed_fields', 'fields', 'scf')
_ALIGNED = ('eofs', 'pcs', 'predict')


def _getter_errors(got, ref, own):
    """Largest error per getter of ``got`` against ``ref``: relative to
    the largest entry; p-values absolute; phases as amplitude-weighted
    unit vectors (no wrap at +-pi); ``own`` solves only on the
    phase-free and aligned getters."""
    import numpy as np
    amp = {'spatial_phase': 'spatial_amplitude',
           'temporal_phase': 'temporal_amplitude'}
    errs = {}
    for name, r in ref.items():
        if own and name not in _PHASE_FREE + _ALIGNED:
            continue
        g = got[name]
        if name.endswith('patterns'):
            errs[name] = max(max(_rel(g[0][k], r[0][k]) for k in r[0]),
                             max(float(np.abs(_vals(g[1][k])
                                              - _vals(r[1][k])).max())
                                 for k in r[1]))
        elif name in amp:
            errs[name] = max(_rel(
                _vals(ref[amp[name]][k]) * np.exp(1j * _vals(g[k])),
                _vals(ref[amp[name]][k]) * np.exp(1j * _vals(r[k])))
                for k in r)
        elif isinstance(r, dict):
            errs[name] = max(_rel(_align(g[k], r[k]) if own
                                  and name in _ALIGNED else g[k], r[k])
                             for k in r)
        else:
            errs[name] = _rel(g, r)
    return errs


def small_results(torch):
    """The dense and the truncated model at 256 x 2 x (16 x 32) on the
    card and on the CPU, and the CPU's solution carried to the card:
    every getter against the CPU's."""
    from xmca_tpu_torch.utils.state import install_state, to_state
    from xmca_tpu_torch.xarray import xMCA
    left, right = make_fields(256, 16, 32, seed0=21)
    n = 4
    for solve in ('dense', 'truncated'):
        def build(device):
            mm = xMCA(left, right, device=device)
            if solve == 'truncated':
                mm.set_solver(truncate=n)
            mm.normalize()
            mm.apply_coslat()
            mm.solve(complexify=True)
            mm.rotate(n)
            return mm
        cpu, own = build('cpu'), build('cuda')
        carried = xMCA(left, right, device='cuda')
        install_state(carried, to_state(cpu))
        ref = result_getters(torch, cpu, n, {}, 'cpu')
        sv = _rel(own.singular_values().values, cpu.singular_values().values)
        for label, model in (('carried', carried), ('own', own)):
            errs = _getter_errors(result_getters(torch, model, n, {}), ref,
                                  label == 'own')
            if label == 'own':
                errs['singular_values'] = sv
            tol = SMALL_TOL[label]
            print('small {} model, card ({}) vs CPU, rel errors (tol {:g}; '
                  'p-values absolute): {}'.format(
                      solve, label, tol, ', '.join(
                          '{} {:.1e}'.format(k, v) for k, v in errs.items())))
            _check(all(v <= tol for v in errs.values()),
                   'small {} model: card ({}) and CPU disagree'.format(
                       solve, label))


def int_fields_small(torch):
    """Integer fields on the card: an int32 field pair (256 x 2 x (16 x
    32), the small fields x 10 rounded) promoted to float32 at ingest,
    its model equal bit for bit to the model of its float32 copy."""
    import numpy as np
    from xmca_tpu_torch.api.array import MCA
    fields = [np.rint(10 * np.asarray(f.values)).astype(np.int32)
              for f in make_fields(256, 16, 32, seed0=31)]
    models = []
    for data in (fields, [f.astype(np.float32) for f in fields]):
        m = MCA(*data, device='cuda')
        m.set_solver(truncate=4)
        m.normalize()
        m.solve(complexify=True)
        m.rotate(4)
        models.append(m)
    got, ref = models
    new = fields[0][:16]
    pairs = [('singular_values', got.singular_values(), ref.singular_values()),
             ('variance', got.variance(), ref.variance()),
             ('predict', got.predict(left=new)['left'],
              ref.predict(left=new.astype(np.float32))['left'])]
    for g in ('eofs', 'pcs'):
        for k in ('left', 'right'):
            pairs.append(('{}[{}]'.format(g, k), getattr(got, g)()[k],
                          getattr(ref, g)()[k]))
    unequal = [name for name, a, b in pairs
               if not np.array_equal(a, b, equal_nan=True)]
    print('int_fields_small: int32 fields (256 x 2 x 512) ingested as {}; '
          'results unequal to the float32 copy\'s: {}'.format(
              got._fields['left'].dtype, unequal or 'none'))
    _check(not unequal and got._fields['left'].dtype == torch.complex64,
           'int_fields_small: the int32 model differs from the float32 '
           'one in {}'.format(unequal))


def _kept(v):
    """Runs kept in each mode's row of a bootstrap ensemble: a run whose
    rotation did not converge leaves its rows zero."""
    return (v != 0).sum(axis=1)


def boot_path(torch, m, card):
    """``bootstrapping`` on the main path's model at full width: the
    standard and the iterative strategy, and one block spanning the
    record against the model's own rotated variance."""
    import numpy as np
    from xmca_tpu_torch.ops import _build
    walls = {}
    z_before = not m._complexify_pending
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    std = _timed(torch, walls, 'standard', lambda: _vals(m.bootstrapping(
        N_BOOT, n_modes=N_ROT, block_size=BOOT_BLOCK, seed=SEED)))
    z_standard = not m._complexify_pending
    it = _timed(torch, walls, 'iterative', lambda: _vals(m.bootstrapping(
        N_BOOT_ITER, n_modes=3, block_size=BOOT_BLOCK, strategy='iterative',
        seed=SEED)))
    one = _timed(torch, walls, 'single block', lambda: _vals(
        m.bootstrapping(2, n_modes=N_ROT, block_size=N_OBS, seed=SEED)))
    launches = _build.launch_counts()
    growth = torch.cuda.max_memory_allocated() - base
    var = _vals(m.variance(N_ROT))
    mode_err = float(np.abs(one / var[:, None] - 1).max())
    sum_err = float(np.abs(one.sum(axis=0) / var.sum() - 1).max())
    _print_walls('boot_path at {} x 2 x {} f32 (truncated, complexified, '
                 'rotate({})), block {} steps; {}'.format(
                     N_OBS, N_LAT * N_LON, N_ROT, BOOT_BLOCK, card), walls)
    print('boot_path: standard {:.4f} s/run ({} runs), iterative {:.4f} s/run '
          '({} runs x 3 modes = {:.4f} s a round); runs kept per mode: '
          'standard {}, iterative {}; Z resident before: {}, after the '
          'standard runs: {}, after the iterative runs: {}; peak device '
          'memory {:.2f} GB above the {:.2f} GB resident; launches {} (the '
          'bootstrap runs no hand-written kernel); {}'.format(
              walls['standard'] / N_BOOT, N_BOOT,
              walls['iterative'] / N_BOOT_ITER, N_BOOT_ITER,
              walls['iterative'] / (3 * N_BOOT_ITER), _kept(std).tolist(),
              _kept(it).tolist(), z_before, z_standard,
              not m._complexify_pending, growth / 1e9, base / 1e9,
              launches, card))
    print('boot_path single block ({} steps): rotated variance vs the '
          "model's, per mode rel {:.2e} (tol {:g}), the sum over modes rel "
          '{:.2e} (tol {:g}): runs rotate to tol 1e-4, the model to 1e-8'
          .format(N_OBS, mode_err, SINGLE_BLOCK_TOL['mode'], sum_err,
                  SINGLE_BLOCK_TOL['sum']))
    for name, v, shape in (('standard', std, (N_ROT, N_BOOT)),
                           ('iterative', it, (3, N_BOOT_ITER)),
                           ('single block', one, (N_ROT, 2))):
        _check(v.shape == shape and np.isfinite(v).all(),
               'bootstrap {}: shape {} (expected {}) or non-finite'.format(
                   name, v.shape, shape))
        _check((_kept(v) >= 0.9 * shape[1]).all(),
               'bootstrap {} kept {} of {} runs'.format(
                   name, _kept(v).tolist(), shape[1]))
    _check(mode_err <= SINGLE_BLOCK_TOL['mode']
           and sum_err <= SINGLE_BLOCK_TOL['sum'],
           "single-block bootstrap differs from the model's variance")
    return {'walls': walls, 'growth_gb': growth / 1e9}


def boot_small(torch):
    """Both strategies on a small model, on the card and on the CPU, with
    the CPU's solution carried to the card: the same resample indices and
    start blocks (CPU generators) on both sides.  The runs rotate to the
    f32 floor (tol 1e-8), where the fixed point is defined; at 1e-4 the
    stopping point moves with f32 roundoff."""
    import numpy as np
    from xmca_tpu_torch.utils.state import install_state, to_state
    from xmca_tpu_torch.xarray import xMCA
    left, right = make_fields(256, 16, 32, seed0=41)
    cpu = xMCA(left, right, device='cpu')
    cpu.set_solver(truncate=4, ensemble_tol=1e-8)
    cpu.normalize()
    cpu.apply_coslat()
    cpu.solve(complexify=True)
    cpu.rotate(4)
    card = xMCA(left, right, device='cuda')
    install_state(card, to_state(cpu))
    card.set_solver(truncate=4, ensemble_tol=1e-8)
    errs = {}
    for strategy, n_runs, n_modes in (('standard', 8, 4), ('iterative', 2, 3)):
        got, ref = (_vals(mm.bootstrapping(n_runs, n_modes=n_modes,
                                           block_size=16, strategy=strategy,
                                           seed=SEED))
                    for mm in (card, cpu))
        _check(np.array_equal(got == 0, ref == 0) and (ref != 0).any(),
               'small bootstrap {}: card and CPU keep other runs'.format(
                   strategy))
        errs[strategy] = float(np.abs(got[ref != 0] / ref[ref != 0]
                                      - 1).max())
    print('small bootstrap card vs CPU at 256 x 2 x 512 (carried state, '
          'block 16): rel standard {:.2e}, iterative {:.2e} (tol 1e-3)'
          .format(errs['standard'], errs['iterative']))
    _check(max(errs.values()) <= 1e-3, 'small bootstrap: card and CPU '
           'disagree')


def make_fields_on_card(torch, n_obs, n_lat, n_lon, seed0):
    """``make_fields``' kind of red-spectrum f32 fields, drawn on the card
    from seeded generators (a host draw of 10^9 normals takes minutes) and
    copied to the host as the DataArrays a user passes."""
    import numpy as np
    from xmca_tpu_torch.xarray import DataArray
    t = torch.arange(n_obs, dtype=torch.float32, device='cuda')
    k = torch.arange(1, 9, dtype=torch.float32, device='cuda')
    modes = torch.sin(2 * np.pi * t[:, None] * k[None, :] / n_obs)
    p = n_lat * n_lon
    coords = {'time': np.arange(n_obs, dtype=np.float32),
              'lat': np.linspace(-60, 60, n_lat, dtype=np.float32),
              'lon': np.linspace(0, 359, n_lon, dtype=np.float32)}
    out = []
    for seed in (seed0, seed0 + 1):
        gen = torch.Generator(device='cuda').manual_seed(seed)
        data = modes @ torch.randn((8, p), generator=gen, device='cuda')
        data += torch.randn((n_obs, p), generator=gen, device='cuda')
        host = data.cpu().numpy()
        del data
        out.append(DataArray(host.reshape(n_obs, n_lat, n_lon),
                             dims=('time', 'lat', 'lon'), coords=coords))
    return out


def _long_syrk(torch, X):
    """K1 int8 on the +-1 ``X``: bit-equal to its plain version (an f64
    matmul on the card), a median of 12 launches beside its bound and
    ``torch._int_mm``'s full product, and the band sweep
    (:func:`syrk_sweep`)."""
    from xmca_tpu_torch.ops.syrk import syrk, syrk_reference
    n_pad, p_pad = X.shape
    G, ref = syrk(X, pm1=True), syrk_reference(X)
    torch.cuda.synchronize()
    err = float((G - ref).abs().max())
    _check(torch.equal(G, ref), 'syrk int8 differs at {}'.format(
        (n_pad, p_pad)))
    del G
    k1 = dict(shape=[n_pad, p_pad], max_abs_err=err,
              **_launch_ms(torch, lambda: syrk(X, pm1=True), 12),
              plain_ms=_time_ms(torch, lambda: syrk_reference(X), 1),
              library_ms=_launch_ms(torch, lambda: torch._int_mm(X, X.T),
                                    10)['ms'],
              **_gram_bound(n_pad, p_pad, 1, 'int8'))
    k1['sweep'] = syrk_sweep(torch, X, ref, 12)
    return k1


def long_kernels(torch):
    """K1 (int8) and K2 at the long record's shape against their plain
    versions, timed beside their bounds and K1's library call; K1 also
    at the fold's longest record, (8192, 100096) (``k1['fold']``)."""
    from xmca_tpu_torch.ops.surrogate import (sign_field_sums,
                                              sign_field_sums_reference)
    from xmca_tpu_torch.ops.syrk import pad_to
    p = N_LAT * N_LON
    n_pad, p_pad = pad_to(N_LONG, p)
    X, s = sign_field_sums(99, N_LONG, p, n_pad, p_pad, 'cuda')
    Xr, sr = sign_field_sums_reference(99, N_LONG, p, n_pad, p_pad, 'cuda')
    torch.cuda.synchronize()
    _check(torch.equal(X, Xr) and torch.equal(s, sr),
           'sign_field_sums differs at {}'.format((N_LONG, p)))
    k2_err = float((X.int() - Xr.int()).abs().max())
    del Xr, sr
    k1 = _long_syrk(torch, X)
    del X, s
    X, _ = sign_field_sums(98, N_FOLD, p, *pad_to(N_FOLD, p), 'cuda')
    k1['fold'] = _long_syrk(torch, X)
    del X
    k2 = dict(shape=[n_pad, p_pad], max_abs_err=k2_err,
              ms=_time_ms(torch, lambda: sign_field_sums(
                  5, N_LONG, p, n_pad, p_pad, 'cuda'), 5),
              plain_ms=_time_ms(torch, lambda: sign_field_sums_reference(
                  5, N_LONG, p, n_pad, p_pad, 'cuda'), 1),
              library_ms=None,
              **bound(nbytes=n_pad * p_pad + 4 * p_pad,
                      calls=N_LONG * p_pad // 128))
    for name, k in (('syrk int8', k1), ('syrk int8', k1['fold']),
                    ('sign_field_sums', k2)):
        print('{} at {}: bit-equal to plain; kernel {} = '
              '{:.1f}% of its bound {:.4f} ms ({}); plain {:.3f} ms; '
              'library {}'.format(
                  name, tuple(k['shape']),
                  _spread(k) if 'ms_min' in k else '{:.4f} ms'.format(
                      k['ms']),
                  100 * k['bound_ms'] / k['ms'], k['bound_ms'],
                  k['bound_by'], k['plain_ms'],
                  'torch._int_mm(X, X.T) {:.4f} ms'.format(k['library_ms'])
                  if k['library_ms'] else 'none'))
    return k1, k2


def long_solve_stages(torch, Zl, Zr):
    """The non-fold truncated solve's stages one at a time (warm) on the
    complex fields, with the algebra of
    ``core.fastpath.fast_solve_truncated_totals`` and the model's start
    block; returns the walls and the leading N_ROT singular values."""
    from xmca_tpu_torch.core import fastpath as fp
    walls = {}
    G = _timed(torch, walls, 'two complex Grams',
               lambda: [fp.temporal_gram(Z) for Z in (Zl, Zr)])
    La, Lb = _timed(torch, walls, 'two c64 Cholesky',
                    lambda: [fp._cholesky(g) for g in G])
    del G
    M = _timed(torch, walls, 'reduced kernel', lambda: (La.mH @ Lb)
               / (Zl.shape[0] - 1))
    gen = torch.Generator(device='cuda').manual_seed(0)
    omega = fp.start_block(Zl.shape[0], N_ROT, Zl.dtype, gen)
    U, s, V = _timed(torch, walls, 'subspace SVD (12 iterations)',
                     lambda: fp.subspace_svd(M, omega, k=N_ROT, n_iter=12))
    _timed(torch, walls, 'triangular recovery + spatial vectors',
           lambda: (Zl.mH @ torch.linalg.solve_triangular(La.mH, U,
                                                           upper=True),
                    Zr.mH @ torch.linalg.solve_triangular(Lb.mH, V,
                                                          upper=True)))
    _timed(torch, walls, 'nuclear norm (26 NS steps)',
           lambda: fp.nuclear_norm(M))
    return walls, s.cpu().numpy()


def long_path(torch, card):
    """A 40-year daily record at full grid width through the main path:
    the solve materializes ``Z`` by FFT and runs the subspace pipeline on
    the complex fields (no analytic fold beyond 8192 steps); Rule-N
    builds its n x n Hilbert operator on the card."""
    import numpy as np
    from xmca_tpu_torch.core.fastpath import hilbert_operator
    from xmca_tpu_torch.core.preprocess import analytic_signal
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.xarray import xMCA
    p = N_LAT * N_LON
    walls = {}
    left, right = _timed(torch, walls, 'make fields (card, to host)',
                         lambda: make_fields_on_card(torch, N_LONG, N_LAT,
                                                     N_LON, 31))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    m = _timed(torch, walls, 'ingest',
               lambda: xMCA(left, right, device='cuda'))

    def prepare():
        m.set_solver(truncate=N_ROT)
        m.normalize()
        m.apply_coslat()
    _timed(torch, walls, 'set_solver + normalize + apply_coslat', prepare)
    _timed(torch, walls, 'solve (cold)', lambda: m.solve(complexify=True))
    non_fold = not m._complexify_pending and m._fields['left'].is_complex()
    _timed(torch, walls, 'rotate', lambda: m.rotate(N_ROT))
    null = _timed(torch, walls, 'rule_n',
                  lambda: _vals(m.rule_n(N_LONG_RUNS, seed=SEED)))
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    svals = _vals(m.singular_values(N_ROT))
    var = _vals(m.variance(N_ROT))
    stage_walls, s_stages = long_solve_stages(torch, m._fields['left'],
                                              m._fields['right'])
    stage_err = float(np.abs(s_stages / svals - 1).max())
    del m, left, right
    torch.cuda.empty_cache()

    # the operator Rule-N built: cold and warm build times, and H x
    # against the FFT analytic signal's imaginary part
    h_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        H = hilbert_operator(N_LONG, torch.float32, 'cuda')
        torch.cuda.synchronize()
        h_walls.append(time.perf_counter() - t0)
    x = torch.randn((N_LONG, 4), device='cuda',
                    generator=torch.Generator(device='cuda').manual_seed(3))
    hx = analytic_signal(x.double()).imag
    h_err = float((H @ x - hx).abs().max() / hx.abs().max())
    del H, x, hx
    k1, k2 = long_kernels(torch)

    _print_walls('long_path at {} x 2 x {} f32 (truncate={}, complexified, '
                 'rotate({}), rule_n({})); {}'.format(
                     N_LONG, p, N_ROT, N_ROT, N_LONG_RUNS, card), walls)
    _print_walls('long truncated solve stage by stage (warm, on the '
                 "model's Z; singular values rel {:.1e} of the model's)"
                 .format(stage_err), stage_walls)
    print('long_path: rule_n {:.4f} s/run; solve took the non-fold branch '
          '(Z by FFT): {}; launches {}; peak device memory {:.2f} GB; '
          'Hilbert operator ({} x {} f32) built in {:.4f} s cold, {:.4f} s '
          'warm, H x vs the f64 FFT analytic signal rel {:.2e} (tol 1e-4); '
          'singular values {}; rotated variance {}; Rule-N kept {} of {} '
          'runs; {}'.format(
              walls['rule_n'] / N_LONG_RUNS, non_fold, launches, peak / 1e9,
              N_LONG, N_LONG, h_walls[0], h_walls[1], h_err,
              np.array2string(svals, precision=4),
              np.array2string(var, precision=4), null.shape[1], N_LONG_RUNS,
              card))
    _check(non_fold, 'the long solve deferred Z (the fold branch)')
    _check(stage_err <= 1e-4, 'the stage-by-stage long solve differs from '
           "the model's: {:.2e}".format(stage_err))
    # f32 H and an f32 product over 14610 terms against f64 FFTs
    _check(h_err <= 1e-4, 'the long Hilbert operator is off: {:.2e}'
           .format(h_err))
    _launch_gate('long path', launches, N_LONG_RUNS)
    _check(np.isfinite(svals).all() and np.isfinite(var).all()
           and np.isfinite(null).all(), 'long path: non-finite results')
    _check(null.shape[0] == N_ROT and null.shape[1] >= 3,
           'long Rule-N kept {} of {} runs'.format(null.shape[1],
                                                  N_LONG_RUNS))
    return (dict(k1, launches=launches['syrk']),
            dict(k2, launches=launches['sign_field_sums']),
            {'walls': walls, 'peak_gb': peak / 1e9, 'h_walls': h_walls})


N_SAVELOAD_RUNS = 16  # Rule-N runs on the saved and the loaded model
# Rule-N runs of each ensemble configuration: cut for time only
N_ENS = {'draw': 8, 'exact': 2, 'normal16': 8, 'normal32': 8,
         'rademacher': 8, 'rademacher1': 16}
# runs of the +-1 null rotated to tol 1e-8, the 'draw' runs' reference
N_REF_1E8 = 32
_KERNELS = ('syrk', 'sign_field_sums', 'surrogate_gram', 'surrogate_project',
            'surrogate_field', 'ses_sweep', 'pm1_project')


def _counts(launches):
    return {k: launches.get(k, 0) for k in _KERNELS}


def saveload_path(torch, m, left, right, card):
    """Save the main path's model and load it into a fresh one: the
    ``info.xmca`` file and the three arrays ``save_analysis`` writes (the
    netCDF writer needs h5py, which the card's machine may lack), the
    array-level load plus ``xMCA``'s coslat step; its getters against the
    model's, ``rule_n`` on both; the file round trip where h5py is
    installed; and a time-varying weight on a fresh model."""
    import importlib.util
    import os
    import shutil
    import tempfile
    import numpy as np
    from xmca_tpu_torch.api.array import MCA
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.xarray import DataArray, xMCA
    walls = {}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    folder = tempfile.mkdtemp(prefix='saveload_', dir=_build.BUILD_DIR)
    _timed(torch, walls, 'info.xmca', lambda: m._create_info_file(folder))
    info = os.path.join(folder, 'info.xmca')

    def arrays():
        fields = m.fields(original_scale=True)
        return ({k: np.ascontiguousarray(_vals(f).real)
                 for k, f in fields.items()},
                {k: _vals(e) for k, e in m.eofs(rotated=False).items()},
                _vals(m.singular_values()), fields)
    fields, eofs, svals, das = _timed(torch, walls, 'the saved arrays',
                                      arrays)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def load():
        lm = xMCA(device='cuda')
        lm._field_coords = {k: da.coords for k, da in das.items()}
        lm._field_dims = {k: da.dims for k, da in das.items()}
        MCA.load_analysis(lm, info, fields=fields, eofs=eofs,
                          singular_values=svals)
        if lm._analysis['is_coslat_corrected']:
            lm.apply_coslat()
        return lm
    lm = _timed(torch, walls, 'load (array level + coslat)', load)
    load_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    # normalize resets the coslat flag, so a normalized and coslat-weighted
    # analysis loads without its weights (the JAX package and the original
    # xmca do the same); weight it again, as the original's own test does
    coslat_lost = not lm._analysis['is_coslat_corrected']
    if coslat_lost:
        lm.apply_coslat()
    sv_equal = np.array_equal(_vals(lm.singular_values(N_ROT)),
                              _vals(m.singular_values(N_ROT)))
    eof_equal = all(np.array_equal(_vals(a[k]), _vals(b[k]), equal_nan=True)
                    for a, b in [(lm.eofs(N_ROT, rotated=False),
                                  m.eofs(N_ROT, rotated=False))]
                    for k in a)
    errs = {'variance': _rel(lm.variance(N_ROT), m.variance(N_ROT)),
            'eofs': max(_rel(lm.eofs(N_ROT)[k], m.eofs(N_ROT)[k])
                        for k in ('left', 'right')),
            'pcs': max(_rel(lm.pcs(N_ROT)[k], m.pcs(N_ROT)[k])
                       for k in ('left', 'right'))}
    nulls, launches = [], []
    for model in (m, lm):
        _build.reset_launch_counts()
        nulls.append(_timed(torch, walls, 'rule_n({}) {}'.format(
            N_SAVELOAD_RUNS, 'loaded' if model is lm else 'saved'),
            lambda: _vals(model.rule_n(N_SAVELOAD_RUNS, seed=SEED))))
        launches.append(_counts(_build.launch_counts()))
    scale = float(_vals(lm.variance()).sum() / _vals(m.variance()).sum())
    null_err = float(np.abs(nulls[1] / (nulls[0] * scale) - 1).max())
    del lm
    file_trip = 'not run: h5py is not installed'
    if importlib.util.find_spec('h5py') is not None:
        def trip():
            m.save_analysis(os.path.join(folder, 'files'))
            fm = xMCA(device='cuda')
            fm.load_analysis(os.path.join(folder, 'files', 'info.xmca'))
            return _vals(fm.singular_values(N_ROT))
        s_files = _timed(torch, walls, 'save_analysis + load_analysis',
                         trip)
        _check(np.array_equal(s_files, _vals(m.singular_values(N_ROT))),
               'the file round trip changed the singular values')
        file_trip = 'ran (h5py): singular values equal'
    shutil.rmtree(folder)

    # a ('time',) weight takes the host path: field to the host, product,
    # back to the card
    fresh = xMCA(left, right, device='cuda')
    w = np.linspace(0.5, 1.5, N_OBS).astype(np.float32)
    weight = DataArray(w, dims=('time',), coords={'time': left.coords[
        'time'].values})
    _timed(torch, walls, 'apply_weights(time-varying)',
           lambda: fresh.apply_weights(left=weight))
    cols = np.random.default_rng(3).choice(N_LAT * N_LON, 64, replace=False)
    x = np.asarray(left.values, dtype=np.float64).reshape(N_OBS, -1)[:, cols]
    ref = (x - x.mean(axis=0)) * w[:, None]
    got = fresh._fields['left'][:, torch.as_tensor(cols, device='cuda')]
    w_err = _rel(got.cpu().numpy(), ref)
    w_dtype = fresh._fields['left'].dtype
    del fresh

    _print_walls('saveload_path at {} x 2 x {} f32 (the main path model: '
                 'truncated, complexified, rotate({})); {}'.format(
                     N_OBS, N_LAT * N_LON, N_ROT, card), walls)
    print('saveload_path: load grew device memory by {:.2f} GB at its peak; '
          'singular values equal: {}, unrotated EOFs equal: {}; coslat '
          'weights lost by the load (kept from the JAX package): {}; rel '
          'errors variance {:.2e} (tol 1e-5), rotated EOFs {:.2e} (tol '
          '1e-4), PCs {:.2e} (tol 1e-4); rule_n({}) saved vs loaded at the '
          'same seed, over the ratio of the rescaling totals {:.8f}: rel '
          '{:.2e} (tol 1e-4); launches saved {}, loaded {}; file round '
          'trip {}; time-varying weight: 64 columns vs numpy rel {:.2e} '
          '(tol 1e-6), field dtype {}'.format(
              load_gb, sv_equal, eof_equal, coslat_lost, errs['variance'],
              errs['eofs'], errs['pcs'], N_SAVELOAD_RUNS, scale, null_err,
              launches[0], launches[1], file_trip, w_err, w_dtype))
    _check(sv_equal and eof_equal, 'the load changed the singular values '
           'or the unrotated EOFs')
    _check(errs['variance'] <= 1e-5 and errs['eofs'] <= 1e-4
           and errs['pcs'] <= 1e-4, 'the loaded getters differ: {}'
           .format(errs))
    for lc in launches:
        _check(lc['syrk'] == lc['sign_field_sums'] == lc['pm1_project']
               == 2 * N_SAVELOAD_RUNS,
               'rule_n on the saved/loaded model launched {}'.format(lc))
    _check(null_err <= 1e-4 and min(n.shape[1] for n in nulls)
           >= 0.9 * N_SAVELOAD_RUNS and np.isfinite(nulls[1]).all(),
           'the loaded model\'s Rule-N differs: {:.2e}'.format(null_err))
    _check(w_err <= 1e-6 and w_dtype == torch.float32,
           'the time-varying weight is off: {:.2e} {}'.format(w_err, w_dtype))
    return {'walls': walls, 'load_gb': load_gb}


def _config(m, name):
    """Point ``m``'s Rule-N at configuration ``name`` with set_solver:
    'draw' and 'exact' leave the rotation settings to ``rule_n``'s
    resolution; the generated ones pin them at the values it resolves to
    for the generated source (tol 1e-4, 6 iterations), 'rademacher8 at
    1e-8' at those it resolves to for 'draw' (tol 1e-8, 12)."""
    if name == 'draw':
        m.set_solver(surrogate_source='draw')
    elif name == 'exact':
        m.set_solver(spectrum='exact', surrogate_source='draw')
    elif name == 'rademacher8 at 1e-8':
        m.set_solver(spectrum='fast', surrogate_source='generated',
                     surrogate_gen_dist='rademacher8', ensemble_tol=1e-8,
                     ensemble_subspace_iters=m._subspace_iters)
    else:
        m.set_solver(spectrum='fast', surrogate_source='generated',
                     surrogate_gen_dist=name, ensemble_tol=1e-4,
                     ensemble_subspace_iters=6)


def _z(null, ref):
    """Per mode |mean difference| over its standard error, the spread
    taken from the reference's runs (32 or 64; both samples share it if
    they are the same null, and a sample of 2 runs cannot estimate it)."""
    import numpy as np
    se = ref.std(axis=1, ddof=1) * np.sqrt(1.0 / null.shape[1]
                                           + 1.0 / ref.shape[1])
    return np.abs(null.mean(axis=1) - ref.mean(axis=1)) / se


def ensemble_path(torch, m, null_r8, card):
    """Rule-N on the main path's model in every other configuration: the
    'draw' source with the fast and the exact spectrum, and the generated
    'normal16', 'normal32', 'rademacher' and 'rademacher1'.  Each mean
    null is held to a +-1 null rotated alike, within 5 standard errors:
    the generated ones to the main path's 'rademacher8' null (tol 1e-4),
    the 'draw' ones to a 'rademacher8' null rotated to their tol 1e-8
    (a tol-1e-4 varimax stops where the modes' variances are less even,
    which moves the rescaled null by a few 1e-3, many standard errors)."""
    import numpy as np
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.stats import significance as sig
    dense_calls = []
    dense = sig.solve_rotated_variance

    def counted(*args, **kw):
        dense_calls.append(1)
        return dense(*args, **kw)
    sig.solve_rotated_variance = counted
    nulls = {'rademacher8': null_r8}
    rows = {}
    order = list(N_ENS.items())
    # after the 'draw' runs, which take the rotation settings rule_n
    # resolves to for them, and before the generated ones
    order.insert(2, ('rademacher8 at 1e-8', N_REF_1E8))
    for name, n_runs in order:
        _config(m, name)
        cfg = m._rule_n_config()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        del dense_calls[:]
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        null = nulls[name] = _vals(m.rule_n(n_runs, seed=SEED))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(_build.launch_counts())
        growth = (torch.cuda.max_memory_allocated() - base) / 1e9
        left = (torch.cuda.memory_allocated() - base) / 1e9
        rows[name] = dict(s_per_run=wall / n_runs, kept=null.shape[1] / n_runs,
                          growth_gb=growth, launches=launches,
                          dense_solves=len(dense_calls),
                          tol=cfg['tol'])
        print('ensemble_path {} (source {}, spectrum {}, dist {}, dtype {}, '
              'tol {:g}, polar {}, {} subspace iterations), N={}: {:.4f} '
              's/run, kept {}/{}; peak device memory +{:.2f} GB ({:.2f} GB '
              'left after); launches {}; dense rotated solves {}; {}'.format(
                  name, cfg['surrogate_source'], cfg['spectrum'],
                  cfg['surrogate_dist'], cfg['dtype'], cfg['tol'],
                  cfg['polar_method'], cfg['subspace_iters'], n_runs,
                  wall / n_runs, null.shape[1], n_runs, growth, left,
                  launches, len(dense_calls), card))
        _check(null.shape == (N_ROT, null.shape[1])
               and null.shape[1] >= 0.9 * n_runs and np.isfinite(null).all(),
               '{}: kept {} of {} runs or non-finite'.format(
                   name, null.shape[1], n_runs))
        want = dict.fromkeys(_KERNELS, 0)
        if name in ('normal16', 'normal32', 'rademacher'):
            want['surrogate_field'] = 2 * n_runs
        elif name in ('rademacher1', 'rademacher8 at 1e-8'):
            want['syrk'] = want['sign_field_sums'] = 2 * n_runs
            want['pm1_project'] = 2 * n_runs
        _check(launches == want, '{} launched {}, not {}'.format(
            name, launches, want))
        _check(len(dense_calls) == (n_runs if name == 'exact' else 0),
               '{}: {} dense rotated solves'.format(name, len(dense_calls)))
        if name == 'rademacher1':
            _config(m, 'rademacher8')
            r8 = _vals(m.rule_n(n_runs, seed=SEED))
            _check(np.array_equal(null, r8), "'rademacher1' is not "
                   "'rademacher8' at the same seed")
            print("ensemble_path: 'rademacher1' equal bit for bit to "
                  "'rademacher8' at seed {} (N={})".format(SEED, n_runs))
    sig.solve_rotated_variance = dense
    for name, row in rows.items():
        ref = 'rademacher8 at 1e-8' if row['tol'] < 1e-4 else 'rademacher8'
        if name == ref:
            continue
        z = _z(nulls[name], nulls[ref])
        print("ensemble_path {}: mean null over the main path's per mode {}; "
              'against {}: |difference| / SE per mode {} (tol 5)'.format(
                  name, np.array2string(nulls[name].mean(axis=1)
                                        / null_r8.mean(axis=1), precision=4),
                  ref, np.array2string(z, precision=2)))
        _check(z.max() <= 5, '{}: mean null off the {} one by {:.2f} '
               'standard errors'.format(name, ref, z.max()))
    # the main path's configuration again (the pinned values are the ones
    # the generated source resolves to)
    _config(m, 'rademacher8')
    return rows


def fast_vs_exact(torch, card):
    """One injected Gaussian field pair (8 planted modes plus noise, drawn
    on the card, normalized and coslat-weighted as the main path does, as
    in PR 5's comparison) through ``_surrogate_variance`` complexified and
    unrotated with both spectra: the singular values the fast spectrum's
    12 subspace iterations resolve, at PR 5's bound for truncated against
    dense (1e-4).  The totals are printed, as PR 5 printed them: the fast
    one is the nuclear norm of the jittered kernel on the 1e-4 schedule,
    and the jitter lifts the null half of the analytic Grams' spectrum."""
    import numpy as np
    from xmca_tpu_torch.core.fastpath import hilbert_operator, start_block
    from xmca_tpu_torch.stats.significance import _surrogate_variance
    from xmca_tpu_torch.xarray import xMCA
    prep = xMCA(*make_fields_on_card(torch, N_OBS, N_LAT, N_LON, 51),
                device='cuda')
    prep.normalize()
    prep.apply_coslat()
    fields = [prep._fields[k] for k in ('left', 'right')]
    del prep
    H = hilbert_operator(N_OBS, torch.float32, 'cuda')
    omega = start_block(N_OBS, N_ROT, torch.complex64,
                        torch.Generator().manual_seed(0)).to('cuda')
    walls = {}
    s_f, t_f, _ = _timed(torch, walls, 'fast', lambda: _surrogate_variance(
        fields, True, False, N_ROT, 1, 1e-8, 'gram', spectrum='fast',
        n_modes_fast=N_ROT, subspace_iters=12, omega=omega, hilbert_H=H))
    s_e, t_e, _ = _timed(torch, walls, 'exact', lambda: _surrogate_variance(
        fields, True, False, N_ROT, 1, 1e-8, 'gram', spectrum='exact'))
    s_f, s_e = s_f.cpu().numpy(), s_e.cpu().numpy()
    resolved = (s_e[N_ROT + 16] / s_e[:N_ROT]) ** (2 * 12) <= 1e-6
    sv_err = np.abs(s_f / s_e[:N_ROT] - 1)
    tot_err = abs(float(t_f) / float(t_e) - 1)
    print('fast vs exact spectrum on one injected field pair ({} x 2 x {}, '
          'complexified): {}; singular values rel {}, resolved modes {} '
          '(tol 1e-4 there); totals rel {:.2e}; {}'.format(
              N_OBS, N_LAT * N_LON, ', '.join(
                  '{} {:.4f} s'.format(k, v) for k, v in walls.items()),
              np.array2string(sv_err, precision=2),
              np.nonzero(resolved)[0] + 1, tot_err, card))
    _check(resolved.sum() >= 4, 'the fast spectrum resolves {} modes'
           .format(resolved.sum()))
    _check((sv_err[resolved] <= 1e-4).all(),
           'the fast and the exact spectra disagree')


PROJECT_BLOCKS = 7   # column blocks the main width's back-projection is
                     # cut into by project_blocks
N_BLOCK_RUNS = 4     # rule_n runs whose first projection is checked
# a back-projection against another evaluation, rel Frobenius: f32 sums
# of 2000 +-1 terms, whose largest entries move by ~1e-6 of the largest
# between two summation orders (the f64 product included)
PROJECT_TOL = 1e-6


def _first_projection(fp, store, keep):
    """Wrap ``fp._pm1_project`` so that ``keep(X, S, p, result)`` of its
    first call goes to ``store``; returns what puts it back."""
    inner = fp._pm1_project

    def first(X, S, p):
        out = inner(X, S, p)
        if not store:
            store.append(keep(X, S, p, out))
        return out
    fp._pm1_project = first
    return lambda: setattr(fp, '_pm1_project', inner)


def project_blocks(torch, m):
    """The +-1 back-projection at the main path's width: the kernel's
    first projection of ``m.rule_n(N_BLOCK_RUNS)`` (2 x N_BLOCK_RUNS
    launches) against the plain version on the same field and weights in
    one column block (the default ``core.fastpath._PROJECT_BYTES``) and
    in PROJECT_BLOCKS (patched), and each against an f64 product, within
    PROJECT_TOL; the kernel and the plain version in one block timed."""
    from xmca_tpu_torch.core import fastpath as fp
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.ops.syrk import pad_to
    p = N_LAT * N_LON
    n_pad, p_pad = pad_to(N_OBS, p)
    first = []
    restore = _first_projection(fp, first, lambda X, S, p_, out: (X, S, out))
    _build.reset_launch_counts()
    _vals(m.rule_n(N_BLOCK_RUNS, seed=SEED))
    launches = _build.launch_counts().get('pm1_project', 0)
    restore()
    X, S, kernel = first[0]
    S_pad = torch.zeros((n_pad, S.shape[1]), device='cuda')
    S_pad[:N_OBS] = S
    one = len(range(0, p, fp._pm1_cols(n_pad)))
    whole = fp._pm1_project_plain(X, S_pad, p)
    kernel_ms = _time_ms(torch, lambda: fp._pm1_project(X, S, p), 10)
    plain_ms = _time_ms(torch, lambda: fp._pm1_project_plain(X, S_pad, p),
                        10)
    default = fp._PROJECT_BYTES
    fp._PROJECT_BYTES = 4 * n_pad * -(-p_pad // PROJECT_BLOCKS)
    try:
        blocks = len(range(0, p, fp._pm1_cols(n_pad)))
        cut = fp._pm1_project_plain(X, S_pad, p)
    finally:
        fp._PROJECT_BYTES = default
    exact = (X.double().T @ S_pad.double())[:p]
    errs = {name: (float((a.double() - b).abs().max() / b.abs().max()),
                   float(torch.linalg.norm(a.double() - b)
                         / torch.linalg.norm(b)))
            for name, a, b in (('kernel vs plain', kernel, whole.double()),
                               ('kernel vs f64', kernel, exact),
                               ('plain vs f64', whole, exact),
                               ('plain cut vs f64', cut, exact))}
    print('project_blocks at {} x {} (+-1 int8 {} x {}, S {} x {}): '
          'rule_n({}) launched pm1_project {} times; the plain version in {} '
          'block(s) by default, {} cut: rel (largest entry, Frobenius) {} '
          '(tol {:g} Frobenius); kernel {:.4f} ms, plain in one block {:.4f} '
          'ms'.format(N_OBS, p, n_pad, p_pad, *S.shape, N_BLOCK_RUNS,
                      launches, one, blocks, errs, PROJECT_TOL, kernel_ms,
                      plain_ms))
    _check(launches == 2 * N_BLOCK_RUNS, 'project_blocks: rule_n({}) '
           'launched pm1_project {} times'.format(N_BLOCK_RUNS, launches))
    _check(one == 1 and blocks == PROJECT_BLOCKS,
           'project_blocks: the default budget casts the main width in more '
           'than one block, or the cut one not in {}'.format(PROJECT_BLOCKS))
    _check(all(frob <= PROJECT_TOL for _, frob in errs.values()),
           'the back-projection differs: {}'.format(errs))


def ensemble_small(torch):
    """Rule-N at 256 x 2 x 512 on the card and on the CPU: the generated
    distributions through the public ``rule_n`` with the CPU's solution
    carried to the card (the same Philox bits and start blocks on both);
    the 'draw' solve on injected bf16 fields (the CPU and CUDA generators
    give different streams), fast and exact.  Rotations run to the f32
    floor (tol 1e-8)."""
    import numpy as np
    from xmca_tpu_torch.core.fastpath import hilbert_operator, start_block
    from xmca_tpu_torch.stats.significance import _surrogate_variance
    from xmca_tpu_torch.utils.state import install_state, to_state
    from xmca_tpu_torch.xarray import xMCA
    left, right = make_fields(256, 16, 32, seed0=61)
    cpu = xMCA(left, right, device='cpu')
    cpu.set_solver(truncate=4)
    cpu.normalize()
    cpu.apply_coslat()
    cpu.solve(complexify=True)
    cpu.rotate(4)
    card = xMCA(left, right, device='cuda')
    install_state(card, to_state(cpu))
    errs = {}
    for dist in ('normal16', 'normal32', 'rademacher', 'rademacher1'):
        for mm in (card, cpu):
            mm.set_solver(surrogate_gen_dist=dist, ensemble_tol=1e-8)
        got, ref = (_vals(mm.rule_n(4, seed=SEED)) for mm in (card, cpu))
        _check(got.shape == ref.shape, '{}: card and CPU keep other runs'
               .format(dist))
        errs[dist] = float(np.abs(got / ref - 1).max())
    gen = torch.Generator().manual_seed(5)
    fields = [torch.randn((256, 512), generator=gen).to(torch.bfloat16)
              for _ in range(2)]
    H = hilbert_operator(256, torch.float32)
    omega = start_block(256, 4, torch.complex64, torch.Generator()
                        .manual_seed(6))
    for spectrum in ('fast', 'exact'):
        for rotated in (False, True):
            res = []
            for device in ('cuda', 'cpu'):
                var, total, conv = _surrogate_variance(
                    [f.to(device) for f in fields], True, rotated, 4, 1,
                    1e-8, 'gram', spectrum=spectrum, n_modes_fast=4,
                    subspace_iters=12, omega=omega.to(device),
                    hilbert_H=H.to(device) if spectrum == 'fast' else None)
                _check(conv, "small 'draw' solve did not converge")
                res.append(np.r_[var.cpu().numpy()[:4], float(total)])
            errs['draw {} {}'.format(spectrum, 'rotated' if rotated
                                     else 'unrotated')] = float(
                np.abs(res[0] / res[1] - 1).max())
    print('small Rule-N card vs CPU at 256 x 2 x 512 (carried state; '
          "'draw' on injected bf16 fields), rel (tol 1e-3): {}".format(
              ', '.join('{} {:.1e}'.format(k, v) for k, v in errs.items())))
    _check(max(errs.values()) <= 1e-3, 'small Rule-N: card and CPU disagree')


# ---------------------------------------------------------------------------
# Boundary extension and out-of-core models
# ---------------------------------------------------------------------------
N_EXT_RUNS = 16      # Rule-N runs of each extended or streamed model: cut
                     # for time only
N_EXT_BOOT = 4       # bootstrap runs of each extended model: cut for time
PERIOD = 365         # the fields are daily: a year, and T >= 2 periods, so
                     # the theta forecast deseasonalizes
THETA_COLS = 4096    # theta forecast columns held, f32 card vs f64 CPU
# theta forecasts f32 (card) against f64 (CPU), max |difference| over the
# column's std: tests/integration/test_theta_parity.py's oracle bounds
THETA_TOL = {'max': 5e-3, 'median': 1e-4}
STREAM_CHUNKS = (16384, 9973)   # columns a chunk; 9973 leaves a ragged end
# chunk-backed against in-memory at full width (f32): singular values,
# unrotated EOFs and rotated explained variance of modes 1-8 (9-10 are
# noise in make_fields, inside the noise continuum the subspace iteration
# does not resolve, where the summation order turns them and the varimax
# mixes them), the Rule-N null
STREAM_TOL = {'svals': 1e-4, 'eofs': 1e-3, 'variance': 1e-3, 'null': 1e-5}
N_EOF_MODES = 8
# the record larger than the card: 25 column tiles of one (2000 x 360 x
# 720) block B, each B or -B, = 2000 x (1800 x 3600) per field
WIDE_LAT, WIDE_LON, WIDE_TILES = 360, 720, 25
WIDE_PEAK_GB = 16.0
N_WIDE_RUNS = 4      # Rule-N runs of the wide record: cut for time only
# rule_n's device memory above what is allocated before it: two padded
# int8 fields (13.27 GB each), the projections and the loading stack
WIDE_RULE_N_GB = 40.0


def _launch_gate(label, launches, n_runs):
    """K1, K2 and the back-projection kernel launched exactly 2 x
    ``n_runs`` times (one rotated +-1 Rule-N run draws two fields, forms
    two Grams and projects both fields, at m = 20 in one launch each)."""
    for name in ('syrk', 'sign_field_sums', 'pm1_project'):
        _check(launches.get(name, 0) == 2 * n_runs,
               '{} launched {} {} times, not 2 x {}'.format(
                   label, name, launches.get(name, 0), n_runs))


def theta_probe(torch, left):
    """The theta forecast of the main path's left field at full width, as
    ``complexify(extend='theta')`` forms it (the [field | flipped field]
    block, 2000 x 200000): its wall, cold and warm, and the device kernels
    one call launches (torch.profiler); then THETA_COLS of its columns in
    f32 on the card against f64 on the CPU."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from xmca_tpu_torch.core.theta import theta_forecast
    x = torch.as_tensor(np.asarray(left.values).reshape(N_OBS, -1),
                        device='cuda')
    x = x - x.mean(dim=0)
    both = torch.cat([x, x.flip(0)], dim=1)
    walls = {}
    for name in ('cold', 'warm'):
        _timed(torch, walls, name, lambda: theta_forecast(both, N_OBS,
                                                          PERIOD))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        theta_forecast(both, N_OBS, PERIOD)
        torch.cuda.synchronize()
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.self_device_time_total > 0)
    del both
    cols = np.random.default_rng(5).choice(x.shape[1], THETA_COLS,
                                           replace=False)
    sub = x[:, torch.as_tensor(cols, device='cuda')]
    got = theta_forecast(sub, N_OBS, PERIOD).cpu().numpy()
    sub = sub.cpu().double()
    ref = theta_forecast(sub, N_OBS, PERIOD).numpy()
    dev = np.abs(got - ref).max(axis=0) / sub.numpy().std(axis=0)
    return walls, launches, dev


def extend_path(torch, left, right, card):
    """The main path with boundary extension: for 'exp' and 'theta'
    (period 365), ``xMCA -> set_solver(truncate=10) -> normalize ->
    apply_coslat -> solve(complexify=True, extend=...) -> rotate(10) ->
    rule_n(16)``, the counters reset just before and read just after, then
    ``bootstrapping(4)`` (standard); the SES kernel's launches in each
    stage, gated; the theta forecast's own wall and launches at full
    width and its f32 card error against f64.  Returns the 'exp' model
    (stream_path compares against it) and the SES kernel's launches a
    stage of each."""
    import numpy as np
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.xarray import xMCA
    models, ses_launches = {}, {}
    for extend in ('exp', 'theta'):
        walls = {}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        m = _timed(torch, walls, 'ingest',
                   lambda: xMCA(left, right, device='cuda'))

        def prepare():
            m.set_solver(truncate=N_ROT)
            m.normalize()
            m.apply_coslat()
        _timed(torch, walls, 'set_solver + normalize + apply_coslat',
               prepare)
        _timed(torch, walls, 'solve', lambda: m.solve(
            complexify=True, extend=extend, period=PERIOD))
        ses = {'solve': _build.launch_counts().get('ses_sweep', 0)}
        _timed(torch, walls, 'rotate', lambda: m.rotate(N_ROT))
        null = _timed(torch, walls, 'rule_n', lambda: _vals(
            m.rule_n(N_EXT_RUNS, seed=SEED)))
        launches = _counts(_build.launch_counts())
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        boot = _timed(torch, walls, 'bootstrapping', lambda: _vals(
            m.bootstrapping(N_EXT_BOOT, n_modes=N_ROT,
                            block_size=BOOT_BLOCK, seed=SEED)))
        ses['rotate + rule_n'] = launches['ses_sweep'] - ses['solve']
        ses['bootstrapping'] = (_build.launch_counts().get('ses_sweep', 0)
                                - launches['ses_sweep'])
        svals, var = _vals(m.singular_values(N_ROT)), _vals(m.variance(N_ROT))
        _print_walls('extend_path {} (period {}) at {} x 2 x {} f32; {}'
                     .format(extend, PERIOD, N_OBS, N_LAT * N_LON, card),
                     walls)
        print('extend_path {}: rule_n {:.4f} s/run, bootstrapping {:.4f} '
              's/run; peak device memory through rule_n {:.2f} GB above the '
              '{:.2f} GB resident; launches {}; Rule-N kept {}/{}, bootstrap '
              'runs kept per mode {}; singular values {}; rotated variance {}'
              .format(extend, walls['rule_n'] / N_EXT_RUNS,
                      walls['bootstrapping'] / N_EXT_BOOT, peak, base / 1e9,
                      launches, null.shape[1], N_EXT_RUNS,
                      _kept(boot).tolist(),
                      np.array2string(svals, precision=4),
                      np.array2string(var, precision=4)))
        _check(m._analysis['extend'] == extend
               and m._fields['left'].is_complex(),
               'extend_path {}: the model is not extended'.format(extend))
        _launch_gate('extend_path ' + extend, launches, N_EXT_RUNS)
        # the theta fit sweeps twice a forecast: the solve forecasts both
        # fields, and each bootstrap run (the data route) its resamples
        want = ({'solve': 2 * 2, 'rotate + rule_n': 0,
                 'bootstrapping': 2 * 2 * N_EXT_BOOT} if extend == 'theta'
                else dict.fromkeys(ses, 0))
        print('extend_path {}: ses_sweep launches {} (want {})'.format(
            extend, ses, want))
        _check(ses == want, 'extend_path {}: ses_sweep launched {}, not {}'
               .format(extend, ses, want))
        ses_launches[extend] = ses
        _check(null.shape == (N_ROT, N_EXT_RUNS),
               'extend_path {}: Rule-N kept {} of {} runs'.format(
                   extend, null.shape[1], N_EXT_RUNS))
        _check(boot.shape == (N_ROT, N_EXT_BOOT)
               and (_kept(boot) == N_EXT_BOOT).all(),
               'extend_path {}: bootstrap kept {} of {} runs'.format(
                   extend, _kept(boot).tolist(), N_EXT_BOOT))
        _check(all(np.isfinite(a).all() for a in (svals, var, null, boot)),
               'extend_path {}: non-finite results'.format(extend))
        models[extend] = m
    del models['theta']
    torch.cuda.empty_cache()
    walls, launches, dev = theta_probe(torch, left)
    _print_walls('theta forecast of the [field | flipped field] block ({} x '
                 '{} f32, period {}); {}'.format(N_OBS, 2 * N_LAT * N_LON,
                                                 PERIOD, card), walls)
    print('theta forecast: {} device kernels a call (torch.profiler); {} '
          'columns f32 card vs f64 CPU, max |difference| / column std: max '
          '{:.2e} (tol {:g}), median {:.2e} (tol {:g})'.format(
              launches, THETA_COLS, dev.max(), THETA_TOL['max'],
              np.median(dev), THETA_TOL['median']))
    _check(dev.max() < THETA_TOL['max']
           and np.median(dev) < THETA_TOL['median'],
           'theta forecasts: card f32 and CPU f64 disagree')
    return models['exp'], ses_launches


def _host_loader(torch, arr, width, passes=None):
    """A chunk loader over the host array ``arr (n, p)``: views of
    ``width`` columns.  With ``passes``, each pass appends its seconds, up
    to a device synchronize after its last chunk was taken."""
    def loader():
        t0 = time.perf_counter()
        for s in range(0, arr.shape[1], width):
            yield arr[:, s:s + width]
        if passes is not None:
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
    return loader


def _print_passes(label, passes, gb):
    """The four streamed passes' walls and rates, in the order a solve
    reads the loaders; ``gb`` the bytes of one pass over one field."""
    names = ('Gram left', 'Gram right', 'projection left',
             'projection right')
    print('{}: {}'.format(label, ', '.join(
        '{} {:.3f} s ({:.2f} GB/s)'.format(name, sec, gb / sec)
        for name, sec in zip(names, passes))))


def _stream_vs(ms, ref, null, ref_null):
    """A chunk-backed model against an in-memory one: singular values,
    unrotated EOFs (aligned) and rotated explained variance of modes
    1-N_EOF_MODES, and the Rule-N null over the ratio of the rescaling
    totals.  Returns the errors and the per-mode rotated variance
    errors of all N_ROT modes."""
    import numpy as np
    per_mode = np.abs(_vals(ms.explained_variance(N_ROT))
                      / _vals(ref.explained_variance(N_ROT)) - 1)
    errs = {'svals': _rel(ms.singular_values(N_ROT),
                          ref.singular_values(N_ROT)),
            'variance': float(per_mode[:N_EOF_MODES].max())}
    got, want = ms.eofs(N_ROT, rotated=False), ref.eofs(N_ROT, rotated=False)
    errs['eofs'] = max(_rel(_align(_vals(got[k])[..., :N_EOF_MODES],
                                   _vals(want[k])[..., :N_EOF_MODES]),
                            _vals(want[k])[..., :N_EOF_MODES])
                       for k in want)
    scale = float(_vals(ms.variance()).sum() / _vals(ref.variance()).sum())
    errs['null'] = (float(np.abs(null / (ref_null * scale) - 1).max())
                    if null.shape == ref_null.shape else float('inf'))
    return errs, per_mode


def stream_path(torch, m, m_exp, left, right, card):
    """``xMCA.from_chunks`` over the main path's two host fields through
    ``normalize -> apply_coslat -> solve(complexify=True) -> rotate(10) ->
    rule_n(16)``, with 16384- and 9973-column chunks (a ragged last one),
    then with ``extend='exp'``; each against the in-memory model of the
    same path (``m``, ``m_exp``); the counters reset just before each
    model is built and read just after its ``rule_n``.  Returns the peak
    device memory of the 16384-column solve (GB above the resident), that
    model (``stream_boot_path`` bootstraps it) and the host arrays."""
    import numpy as np
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.xarray import xMCA
    coords = {d: _vals(left.coords[d]) for d in ('time', 'lat', 'lon')}
    arrays = [_vals(f).reshape(N_OBS, -1) for f in (left, right)]
    gb = arrays[0].nbytes / 1e9
    ref_nulls = {None: _vals(m.rule_n(N_EXT_RUNS, seed=SEED)),
                 'exp': _vals(m_exp.rule_n(N_EXT_RUNS, seed=SEED))}
    solve_peak = kept = None
    for width, extend in ((STREAM_CHUNKS[0], False), (STREAM_CHUNKS[1], False),
                          (STREAM_CHUNKS[0], 'exp')):
        ref = m_exp if extend else m
        walls, passes = {}, []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        _build.reset_launch_counts()
        ms = xMCA.from_chunks(
            *[_host_loader(torch, a, width, passes) for a in arrays],
            coords=coords, device='cuda')
        ms.set_solver(truncate=N_ROT)
        ms.normalize()
        ms.apply_coslat()
        torch.cuda.reset_peak_memory_stats()
        _timed(torch, walls, 'solve', lambda: ms.solve(
            complexify=True, extend=extend, period=PERIOD))
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        _timed(torch, walls, 'rotate', lambda: ms.rotate(N_ROT))
        null = _timed(torch, walls, 'rule_n', lambda: _vals(
            ms.rule_n(N_EXT_RUNS, seed=SEED)))
        launches = _counts(_build.launch_counts())
        errs, per_mode = _stream_vs(ms, ref, null, ref_nulls[extend or None])
        label = 'stream_path {}-column chunks{}'.format(
            width, ', extend exp' if extend else '')
        _print_walls('{} at {} x 2 x {} f32; {}'.format(
            label, N_OBS, N_LAT * N_LON, card), walls)
        _print_passes(label + ' passes ({:.3f} GB a field)'.format(gb),
                      passes, gb)
        print('{}: solve peak device memory {:.2f} GB above the {:.2f} GB '
              'resident; launches {}; against the in-memory model: {} '
              '(tol {}); rotated explained variance rel per mode {}'.format(
                  label, peak, base / 1e9, launches, errs, STREAM_TOL,
                  np.array2string(per_mode, precision=2)))
        _launch_gate(label, launches, N_EXT_RUNS)
        _check(all(errs[k] <= STREAM_TOL[k] for k in STREAM_TOL),
               '{}: the chunk-backed model differs: {}'.format(label, errs))
        if solve_peak is None:
            solve_peak, kept = peak, ms
        del ms
    return solve_peak, kept, arrays


def _catch(module, name, store, keep=lambda args, out: (args, out)):
    """Wrap ``module.name`` so that ``keep(args, result)`` of each call is
    appended to ``store``; returns what puts the function back."""
    inner = getattr(module, name)

    def caught(*args, **kw):
        out = inner(*args, **kw)
        store.append(keep(args, out))
        return out
    setattr(module, name, caught)
    return lambda: setattr(module, name, inner)


# A bootstrap run's varimax stops once its criterion changes by less than
# 100 f32 eps (1.2e-5) a step.  The criterion is stationary at its
# optimum, so a step there may still turn the loadings by up to
# ~sqrt(1.2e-5) = 3.5e-3 rad, and two evaluations of the same run that
# differ by roundoff may stop a step apart: a mode's rotated variance is
# defined to about that times the spread of the modes it mixes.  Two
# rotations of the same loadings are held to ROT_STOP_TOL per mode; the
# loadings themselves are held tighter, under the one rotation matrix.
ROT_STOP_TOL = 1e-2


def _rotation_matrices(store):
    """Catch each bootstrap run's rotation matrix (the varimax of
    ``core.fastpath._rotated_variance``)."""
    from xmca_tpu_torch.core import rotation
    return _catch(rotation, 'promax', store, lambda args, out: out[1])


def _variance_with(torch, L, n_left, R):
    """The rotated variance, descending, of the sqrt(s)-scaled loading
    stack ``L`` (``n_left`` rows of the left field) under the rotation
    ``R``, as ``core.fastpath._rotated_variance`` forms it."""
    Lr = L @ R
    v = (torch.linalg.norm(Lr[:n_left], dim=0)
         * torch.linalg.norm(Lr[n_left:], dim=0))
    return torch.sort(v, descending=True).values


def _field_passes(passes, before):
    """The passes each field's loader made since ``before`` (counts per
    field), and their walls."""
    return ({k: len(v) - before[k] for k, v in passes.items()},
            {k: v[before[k]:] for k, v in passes.items()})


def _print_boot_passes(label, walls, gb):
    print('{} passes ({:.3f} GB a field): {}'.format(label, gb, ', '.join(
        '{} {}'.format(k, ', '.join('{:.3f} s ({:.2f} GB/s)'.format(
            sec, gb / sec) for sec in v) or 'none')
        for k, v in walls.items())))


# stream_boot_path's phases: (name, bootstrapping keywords, held against
# the in-memory model, passes (left, right))
STREAM_BOOT = (
    ('standard axis=0', dict(n_runs=16, n_modes=10), True, (1, 1)),
    ('iterative axis=0', dict(n_runs=4, n_modes=3, strategy='iterative'),
     True, (3, 3)),
    ('axis=1 both', dict(n_runs=4, n_modes=10, axis=1, on_left=True,
                         on_right=True), False, (2, 2)),
    ('axis=1 right', dict(n_runs=4, n_modes=10, axis=1, on_left=False,
                          on_right=True), False, (1, 2)),
)


def stream_boot_path(torch, ms, m, arrays, card):
    """``bootstrapping`` of stream_path's 16384-column chunk-backed model
    (normalized, coslat, complexified, rotate(10)) with block 20 and seed
    7, each phase of STREAM_BOOT: its passes a field counted by its
    loaders, its walls, its peak device memory; the time-axis phases
    against the in-memory main-path model ``m`` run for run (the same
    draws): each streamed run's loadings under its own rotation matrix
    against the in-memory run's loadings under that same matrix, modes
    1-N_EOF_MODES within STREAM_TOL['variance'], and each model's own
    rotated variance within ROT_STOP_TOL.  Both models rotate their runs
    to tol 1e-8 here (the f32 floor)."""
    import numpy as np
    from xmca_tpu_torch.core import rotation
    gb = arrays[0].nbytes / 1e9
    passes = {'left': [], 'right': []}
    ms._chunk_loaders = {k: _host_loader(torch, a, STREAM_CHUNKS[0],
                                         passes[k])
                         for k, a in zip(('left', 'right'), arrays)}
    tols = [mm._ensemble_tol for mm in (ms, m)]
    for mm in (ms, m):
        mm.set_solver(ensemble_tol=1e-8)
    for name, kw, vs_memory, expected in STREAM_BOOT:
        kw = dict(kw)
        n_runs = kw.pop('n_runs')
        walls = {}
        before = {k: len(v) for k, v in passes.items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rots, loads = [], []
        restore = _rotation_matrices(rots)
        got = _timed(torch, walls, 'streamed', lambda: _vals(ms.bootstrapping(
            n_runs, block_size=BOOT_BLOCK, seed=SEED, **kw)))
        restore()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        counts, pass_walls = _field_passes(passes, before)
        line = ''
        if vs_memory:
            restore = _catch(rotation, 'promax', loads,
                             lambda args, out: args[0])
            ref = _timed(torch, walls, 'in memory', lambda: _vals(
                m.bootstrapping(n_runs, block_size=BOOT_BLOCK, seed=SEED,
                                **kw)))
            restore()
            # the in-memory runs' loadings under the streamed runs'
            # rotations, written as bootstrapping writes its rounds
            fixed = np.zeros_like(got)
            for j, (L, R) in enumerate(zip(loads, rots)):
                mode, i = divmod(j, n_runs)
                fixed[mode:, i] = _variance_with(
                    torch, L, N_LAT * N_LON, R).cpu().numpy()[
                        :got.shape[0] - mode]
            caught = (len(rots), len(loads))
            del loads
            errs = [np.where(r != 0, np.abs(got / np.where(r != 0, r, 1) - 1),
                             0).max(axis=1) for r in (fixed, ref)]
            line = ('; against the in-memory model run for run, rel per mode: '
                    'its loadings under the same rotations {} (modes 1-{} tol '
                    '{:g}), its own rotated variance {} (tol {:g})'.format(
                        np.array2string(errs[0], precision=2), N_EOF_MODES,
                        STREAM_TOL['variance'],
                        np.array2string(errs[1], precision=2), ROT_STOP_TOL))
            _check(caught == (n_runs * (3 if kw.get('strategy') else 1),) * 2
                   and np.array_equal(got == 0, ref == 0)
                   and errs[0][:N_EOF_MODES].max() <= STREAM_TOL['variance']
                   and errs[1][:N_EOF_MODES].max() <= ROT_STOP_TOL,
                   'stream_boot_path {}: the chunk-backed model differs from '
                   'the in-memory one: {}'.format(name, errs))
        label = 'stream_boot_path {}'.format(name)
        _print_walls('{} ({} runs, {} modes) at {} x 2 x {} f32; {}'.format(
            label, n_runs, got.shape[0], N_OBS, N_LAT * N_LON, card), walls)
        _print_boot_passes(label, pass_walls, gb)
        print('{}: {:.4f} s a run; passes a field {}; peak device memory '
              '{:.2f} GB above the {:.2f} GB resident; runs kept per mode {}'
              '{}'.format(label, walls['streamed'] / n_runs, counts, peak,
                          base / 1e9, _kept(got).tolist(), line))
        _check(np.isfinite(got).all() and (_kept(got) == n_runs).all(),
               '{}: runs kept per mode {} of {}'.format(
                   label, _kept(got).tolist(), n_runs))
        _check((counts['left'], counts['right']) == expected,
               '{}: passes {} (expected {})'.format(label, counts, expected))
    for mm, tol in zip((ms, m), tols):
        mm._ensemble_tol = tol


def stream_boot_small(torch):
    """Chunk-backed models at 256 x 2 x 512 (100-column chunks) on the card
    and on the CPU, each solved on its own device: bootstrapping on the
    time axis (8 runs) and the space axis (4 runs, both fields), runs
    rotated to tol 1e-8; the rotated variance within the small path's
    1e-3."""
    import numpy as np
    from xmca_tpu_torch.xarray import xMCA
    left, right = make_fields(256, 16, 32, seed0=83)
    coords = {d: _vals(left.coords[d]) for d in ('time', 'lat', 'lon')}
    arrays = [_vals(f).reshape(256, -1) for f in (left, right)]
    out = {}
    for device in ('cuda', 'cpu'):
        mm = xMCA.from_chunks(*[_host_loader(torch, a, 100) for a in arrays],
                              coords=coords, device=device)
        mm.set_solver(truncate=4, ensemble_tol=1e-8)
        mm.normalize()
        mm.apply_coslat()
        mm.solve(complexify=True)
        mm.rotate(4)
        out[device] = [_vals(mm.bootstrapping(8, n_modes=4, block_size=16,
                                              seed=SEED)),
                       _vals(mm.bootstrapping(4, n_modes=4, axis=1,
                                              on_left=True, on_right=True,
                                              block_size=16, seed=SEED))]
    errs = []
    for got, ref in zip(out['cuda'], out['cpu']):
        _check(np.array_equal(got == 0, ref == 0) and (ref != 0).all(),
               'stream_boot_small: card and CPU keep other runs')
        errs.append(float(np.abs(got / ref - 1).max()))
    print('stream_boot_small card vs CPU at 256 x 2 x 512, rel rotated '
          'variance: axis=0 {:.2e}, axis=1 {:.2e} (tol 1e-3)'.format(*errs))
    _check(max(errs) <= 1e-3, 'stream_boot_small: card and CPU disagree')


def _wide_axis0_reference(torch, grams, p, H, n_iter):
    """The time-axis bootstrap's n x n reduction of ``grams`` (left,
    right) for the N_BOOT runs of seed SEED, each run's indices and start
    block drawn as the port draws them: the left Gram resampled (the
    default ``on_left=True, on_right=False``), both re-centered, folded,
    jittered at the width ``p`` and factored, the kernel's N_ROT singular
    values.  Returns them and each run's largest condition number of its
    two folded Grams."""
    import numpy as np
    from xmca_tpu_torch.core import fastpath as fp
    from xmca_tpu_torch.stats.significance import _block_indices, run_seeds
    eps = fp._eps(torch.float32)
    svals, kappa = [], []
    for s in run_seeds(SEED, N_BOOT):
        gen = torch.Generator().manual_seed(s)
        idx = _block_indices(gen, N_OBS, BOOT_BLOCK, True).cuda()
        omega = fp.start_block(N_OBS, N_ROT, torch.float32, gen).cuda()
        folded = [fp._fold_jitter(fp._center_gram(g), p, eps, H)
                  for g in (grams[0][idx][:, idx], grams[1])]
        sv = fp._chol_reduce(lambda: [fp._cholesky(f) for f in folded],
                             N_OBS - 1, omega, N_ROT, n_iter,
                             form=False)[4]
        svals.append(sv)
        ev = [torch.linalg.eigvalsh(f) for f in folded]
        kappa.append(max(float(e[-1] / e[0]) for e in ev))
    return torch.stack(svals).cpu().numpy(), np.asarray(kappa)


def wide_stream_path(torch, card, peak_800mb):
    """A record larger than the card: two fields of 2000 steps x (1800 x
    3600) cells (a 0.1-degree grid), 51.8 GB f32 each, streamed by
    ``MCA.from_chunks -> normalize -> set_solver(truncate=10) ->
    solve(complexify=True) -> rotate(10)``.  Each field is 25 column
    tiles of one base block B (2000 x 360 x 720), each tile B or -B by a
    seeded sign, so every pass reads the same host arrays.  Exact gates:
    the streamed Grams are 25 x B's; the spectrum and totals are the port's
    n x n reduction of that Gram at the full width; tile j's unrotated and
    rotated EOFs are its sign times tile 0's.  Its bootstrap runs between
    the solve and the rotation (``wide_boot_time``) and after it
    (``wide_boot_rotated``, ``wide_boot_space``), with B in memory as the
    reference."""
    import numpy as np
    from xmca_tpu_torch.api.array import MCA
    from xmca_tpu_torch.core import fastpath as fp
    walls = {}
    tile = WIDE_LAT * WIDE_LON
    p = WIDE_TILES * tile
    grid = (WIDE_TILES * WIDE_LAT // 5, 5 * WIDE_LON)    # (1800, 3600)
    blocks = _timed(torch, walls, 'base blocks (card, to host)', lambda: [
        _vals(f).reshape(N_OBS, -1) for f in make_fields_on_card(
            torch, N_OBS, WIDE_LAT, WIDE_LON, 71)])
    negs = _timed(torch, walls, 'negated blocks (host)',
                  lambda: [np.negative(b) for b in blocks])
    signs = [np.random.default_rng(73 + i).choice([-1, 1], WIDE_TILES)
             for i in range(2)]
    signs[0][0] = signs[1][0] = 1
    passes = {'left': [], 'right': []}

    def loader(i):
        def chunks():
            t0 = time.perf_counter()
            for s in signs[i]:
                yield blocks[i] if s > 0 else negs[i]
            torch.cuda.synchronize()
            passes[('left', 'right')[i]].append(time.perf_counter() - t0)
        return chunks

    # B in memory: its centered, normalized Gram and its own solve
    def in_memory():
        mm = MCA(*blocks, device='cuda')
        mm.normalize()
        mm.set_solver(truncate=N_ROT)
        mm.solve(complexify=True)
        return mm
    mb = _timed(torch, walls, 'B in memory (ingest, normalize, solve)',
                in_memory)
    grams_b = [f @ f.T for f in (mb._fields['left'], mb._fields['right'])]
    s_b = _vals(mb.singular_values(N_ROT))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = MCA.from_chunks(loader(0), loader(1), n_observations=N_OBS,
                         left_shape=grid, right_shape=grid, device='cuda')
    ms.normalize()
    ms.set_solver(truncate=N_ROT)
    _timed(torch, walls, 'streamed solve', lambda: ms.solve(complexify=True))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    solve_passes = [passes[k][i] for i in (0, 1) for k in ('left', 'right')]
    gb = p * N_OBS * 4 / 1e9
    # the n x n reduction of 25 x B's Gram at the full width
    gram_err = max(float(torch.linalg.norm(ms._stream_grams[k]
                                           - WIDE_TILES * g)
                         / torch.linalg.norm(WIDE_TILES * g))
                   for k, g in zip(('left', 'right'), grams_b))
    H = fp.hilbert_operator(N_OBS, torch.float32, 'cuda')
    wide_boot_time(torch, ms, grams_b, gram_err, H, p, passes, gb, card)
    torch.cuda.reset_peak_memory_stats()
    _timed(torch, walls, 'rotate', lambda: ms.rotate(N_ROT))
    rot_peak = max(peak, (torch.cuda.max_memory_allocated() - base) / 1e9)

    def reduction(grams):
        """The n x n reduction the streamed solve runs, of ``grams``:
        (singular values, totals, the folded Grams' condition numbers)."""
        folded = [fp._fold_jitter(g, p, fp._eps(torch.float32), H)
                  for g in grams]
        gen = torch.Generator(device='cuda')
        gen.manual_seed(0)
        omega = fp.start_block(N_OBS, N_ROT, folded[0].dtype, gen)
        _, _, M, _, s, _ = fp._chol_reduce(
            lambda: [fp._cholesky(f) for f in folded], N_OBS - 1, omega,
            N_ROT, ms._subspace_iters, form=True)
        tot = torch.stack([fp.nuclear_norm(M), torch.sum(torch.abs(M) ** 2)])
        ev = [torch.linalg.eigvalsh(f.to(torch.complex128)) for f in folded]
        return (s.cpu().numpy(), tot.cpu().numpy(),
                max(float(e[-1] / e[0]) for e in ev))

    s_wide = _vals(ms.singular_values(N_ROT))
    got = np.r_[s_wide, ms._analysis['total_covariance'],
                ms._analysis['total_squared_covariance']]
    s_ref, totals, kappa = reduction([WIDE_TILES * g for g in grams_b])
    red_err = np.abs(got / np.r_[s_ref, totals] - 1)
    s_own, totals_own, _ = reduction([ms._stream_grams[k]
                                      for k in ('left', 'right')])
    own_err = float(np.abs(got / np.r_[s_own, totals_own] - 1).max())
    # an f32 Cholesky of a Gram of condition kappa moves its small
    # directions by up to ~kappa x the Gram's relative difference: the
    # noise modes and the totals (sums over every singular value) may
    # move that far between two f32 evaluations of the same Gram
    red_tol = max(1e-4, kappa * gram_err)
    wide_boot_rotated(torch, ms, mb, passes, gb, card)
    wide_boot_space(torch, ms, mb, passes, gb, card)
    del grams_b, mb
    # tile j's EOFs are s_j times tile 0's (rows 72 j .. 72 j + 71)
    rows = tile // grid[1]
    sym_err = 0.0
    for rotated in (False, True):
        eofs = ms.eofs(N_ROT, rotated=rotated)
        for i, k in enumerate(('left', 'right')):
            e = eofs[k]
            e0 = e[:rows]
            scale = np.abs(e0).max()
            for j in range(1, WIDE_TILES):
                sym_err = max(sym_err, float(
                    np.abs(e[j * rows:(j + 1) * rows] - signs[i][j] * e0)
                    .max() / scale))
        del eofs
    _print_walls('wide_stream_path at {} x 2 x {} ({} x {} cells) f32, {:.1f} '
                 'GB a field, {:.1f} GB in all; {}'.format(
                     N_OBS, p, grid[0], grid[1], gb, 2 * gb, card), walls)
    _print_passes('wide_stream_path passes ({:.1f} GB a field)'.format(gb),
                  solve_passes, gb)
    print('wide_stream_path: streamed solve peak device memory {:.2f} GB '
          'above the {:.2f} GB resident (B in memory; tol {:g} GB; the '
          '800 MB fields\' streamed solve: {:.2f} GB), through rotate {:.2f} '
          'GB; streamed Grams vs {t} x B\'s rel Frobenius {:.2e} (tol '
          '1e-5); singular values 1-{m} vs the n x n reduction of {t} x B\'s '
          'Gram at p = {} rel {:.2e} (tol 1e-4); every singular value and '
          'the two totals vs it rel {} (tol {:.2e}: 1e-4, or the folded '
          'Grams\' condition number {:.3e} x the Grams\' difference); vs '
          'the same reduction of the model\'s own Grams rel {:.2e} (tol '
          '1e-6); EOFs tile j vs s_j tile 0, unrotated and rotated, rel '
          '{:.2e} (tol 1e-5); rotate converged in {} iterations; wide '
          'singular values over {t} x B\'s in-memory ones (the jitter bias, '
          'not a gate): {}'.format(
              peak, base / 1e9, WIDE_PEAK_GB, peak_800mb, rot_peak, gram_err,
              p, red_err[:N_EOF_MODES].max(),
              np.array2string(red_err, precision=2), red_tol, kappa, own_err,
              sym_err, ms._rotate_iterations,
              np.array2string(s_wide / (WIDE_TILES * s_b), precision=6),
              t=WIDE_TILES, m=N_EOF_MODES))
    _check(peak < WIDE_PEAK_GB, 'the wide streamed solve took {:.2f} GB'
           .format(peak))
    _check(gram_err <= 1e-5, 'wide Grams differ from 25 x B: {:.2e}'
           .format(gram_err))
    _check(red_err[:N_EOF_MODES].max() <= 1e-4
           and red_err.max() <= red_tol and own_err <= 1e-6,
           'wide spectrum differs from the n x n reduction: {} (own Grams '
           '{:.2e})'.format(red_err, own_err))
    _check(sym_err <= 1e-5, 'wide EOF tiles are not sign copies: {:.2e}'
           .format(sym_err))
    _check(ms._analysis['is_rotated'] and np.isfinite(s_wide).all()
           and np.isfinite(_vals(ms.variance())).all(),
           'wide path: not rotated or non-finite results')
    k1, k2 = wide_rule_n(torch, ms, p, card)
    return {'walls': walls, 'peak_gb': peak, 'passes': solve_passes,
            'k1': k1, 'k2': k2}


def _call_walls(torch, module, name, walls):
    """Wrap ``module.name`` so that the host seconds of each call,
    between two device synchronizes, go to ``walls``; returns what puts
    it back."""
    inner = getattr(module, name)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out
    setattr(module, name, timed)
    return lambda: setattr(module, name, inner)


def wide_rule_n(torch, ms, p, card):
    """``rule_n(N_WIDE_RUNS)`` of the rotated wide model: two padded +-1
    int8 fields of (2048, p) a run, each projected by one launch of the
    back-projection kernel.  Exactly 2 x N_WIDE_RUNS launches of K1, K2
    and pm1_project, every run kept and finite, the peak device memory
    above what is allocated before the call under WIDE_RULE_N_GB.  Run
    0's left field is drawn again after the call (its first 128 columns
    checked against the run's): the run's projection and the plain
    version's (1 GiB f32 column blocks) on the plain version's first, a
    middle and its last column block against an f64 product of those
    columns and the run's weights, within PROJECT_TOL; both timed.  Then
    K1 and K2 at this shape (:func:`wide_kernels`)."""
    import numpy as np
    from xmca_tpu_torch.core import fastpath as fp
    from xmca_tpu_torch.core.rotation import ensemble_space
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.ops.surrogate import sign_field_sums
    from xmca_tpu_torch.ops.syrk import pad_to
    from xmca_tpu_torch.stats.significance import run_seeds
    label = 'wide_stream_path rule_n({})'.format(N_WIDE_RUNS)
    n_pad, p_pad = pad_to(N_OBS, p)
    first, run_walls, walls = [], [], {}
    restore = [
        _first_projection(fp, first, lambda X, S, p_, out: (
            X[:, :128].clone(), S.clone(), out.cpu())),
        _call_walls(torch, fp, 'fast_surrogate_variance_tri', run_walls)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    null = _timed(torch, walls, 'rule_n', lambda: _vals(
        ms.rule_n(N_WIDE_RUNS, seed=SEED)))
    launches = _build.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    for put_back in restore:
        put_back()
    iters = ms._rule_n_iterations
    space = ensemble_space(2 * p, N_ROT, 8)

    # run 0's left field again, its projection block by block in f64
    head, S, out = first[0]
    s0 = run_seeds(SEED, N_WIDE_RUNS)[0]
    X, _ = sign_field_sums((2 * s0) & 0xFFFFFFFF, N_OBS, p, n_pad, p_pad,
                           'cuda')
    same_field = torch.equal(X[:, :128], head)
    S_pad = torch.zeros((n_pad, S.shape[1]), dtype=torch.float64,
                        device='cuda')
    S_pad[:N_OBS] = S.double()
    S32 = S_pad.float()
    plain = fp._pm1_project_plain(X, S32, p).cpu()
    cols = fp._pm1_cols(n_pad)
    starts = list(range(0, p, cols))
    block_err, plain_err = [], []
    for c0 in (starts[0], starts[len(starts) // 2], starts[-1]):
        ref = (X[:, c0:c0 + cols].double().T @ S_pad).cpu()
        for errs, res in ((block_err, out), (plain_err, plain)):
            got = res[c0:c0 + ref.shape[0]].double()
            errs.append((c0, ref.shape[0], float(
                (got - ref).abs().max() / ref.abs().max()), float(
                torch.linalg.norm(got - ref) / torch.linalg.norm(ref))))
        del ref
    proj_ms = _time_ms(torch, lambda: fp._pm1_project(X, S, p), 3)
    plain_ms = _time_ms(torch, lambda: fp._pm1_project_plain(X, S32, p), 3)
    del X, S_pad, S32, out, plain
    torch.cuda.empty_cache()
    field_gb = n_pad * p_pad / 1e9
    print('{} at {} x 2 x {} (+-1 int8 fields {} x {}, {:.2f} GB each): '
          '{:.3f} s, a run {} s; kept {} of {}; launches {}; peak device '
          'memory {:.2f} GB above the {:.2f} GB allocated before (tol {:g} '
          'GB); promax in {!r} space (ensemble_space of {} x {} c64); '
          'rule_n iterations {}; null {}; {}'.format(
              label, N_OBS, p, n_pad, p_pad, field_gb, walls['rule_n'],
              np.array2string(np.asarray(run_walls), precision=4),
              null.shape[1], N_WIDE_RUNS, launches, peak, base / 1e9,
              WIDE_RULE_N_GB, space, 2 * p, N_ROT,
              np.asarray(iters).tolist(),
              np.array2string(null[:, 0], precision=4), card))
    print('{} back-projection: the plain version\'s {} blocks of {} '
          'columns; run 0\'s left field drawn again (its first 128 columns '
          'equal the run\'s: {}), blocks (first column, width, rel vs f64: '
          'largest entry, Frobenius) kernel {}, plain {} (tol {:g} '
          'Frobenius); _pm1_project (the kernel) {:.4f} ms a field, the '
          'plain version {:.4f} ms (the int8 field read once: {:.4f} ms at '
          '{:g} B/s)'.format(
              label, len(starts), cols, same_field, block_err, plain_err,
              PROJECT_TOL, proj_ms, plain_ms,
              1e3 * n_pad * p_pad / PEAK_BYTES, PEAK_BYTES))
    _launch_gate(label, launches, N_WIDE_RUNS)
    _check(null.shape == (N_ROT, N_WIDE_RUNS) and np.isfinite(null).all(),
           '{}: kept {} of {} runs, finite {}'.format(
               label, null.shape[1], N_WIDE_RUNS,
               bool(np.isfinite(null).all())))
    _check(peak < WIDE_RULE_N_GB, '{} took {:.2f} GB'.format(label, peak))
    _check(same_field and len(starts) > 2
           and all(frob <= PROJECT_TOL
                   for _, _, _, frob in block_err + plain_err),
           '{}: the back-projection differs from f64: kernel {}, plain {}'
           .format(label, block_err, plain_err))
    k1, k2 = wide_kernels(torch, p)
    return (dict(k1, launches=launches['syrk']),
            dict(k2, launches=launches['sign_field_sums']))


def wide_kernels(torch, p):
    """K1 (int8) and K2 at the wide record's (2048, p) padded shape:
    bit-equal to their plain versions (K1's summed in f64 column blocks,
    K2's drawn in row blocks), K1 per launch
    (median, least, largest of 5) beside ``torch._int_mm``'s full
    product, both beside their bounds."""
    from xmca_tpu_torch.ops.surrogate import (sign_field_sums,
                                              sign_field_sums_reference)
    from xmca_tpu_torch.ops.syrk import pad_to, syrk, syrk_reference
    n_pad, p_pad = pad_to(N_OBS, p)
    X, s = sign_field_sums(97, N_OBS, p, n_pad, p_pad, 'cuda')
    Xr, sr = sign_field_sums_reference(97, N_OBS, p, n_pad, p_pad, 'cuda')
    torch.cuda.synchronize()
    k2_equal = torch.equal(X, Xr) and torch.equal(s, sr)
    del Xr, sr
    _check(k2_equal, 'sign_field_sums differs at {}'.format((N_OBS, p)))
    G, ref = syrk(X, pm1=True), syrk_reference(X)
    torch.cuda.synchronize()
    k1_err = float((G - ref).abs().max())
    _check(torch.equal(G, ref), 'syrk int8 differs at {}'.format(
        (n_pad, p_pad)))
    del G, ref
    k1 = dict(shape=[n_pad, p_pad], max_abs_err=k1_err,
              **_launch_ms(torch, lambda: syrk(X, pm1=True), 5),
              plain_ms=_time_ms(torch, lambda: syrk_reference(X), 1),
              library_ms=_launch_ms(torch, lambda: torch._int_mm(X, X.T),
                                    3)['ms'],
              **_gram_bound(n_pad, p_pad, 1, 'int8'))
    del X, s
    k2 = dict(shape=[n_pad, p_pad], max_abs_err=0.0,
              ms=_time_ms(torch, lambda: sign_field_sums(
                  5, N_OBS, p, n_pad, p_pad, 'cuda'), 5),
              plain_ms=_time_ms(torch, lambda: sign_field_sums_reference(
                  5, N_OBS, p, n_pad, p_pad, 'cuda'), 1),
              library_ms=None,
              **bound(nbytes=n_pad * p_pad + 4 * p_pad,
                      calls=N_OBS * p_pad // 128))
    for name, k in (('syrk int8', k1), ('sign_field_sums', k2)):
        print('{} at {}: bit-equal to plain; kernel {} = {:.1f}% of its '
              'bound {:.4f} ms ({}); plain {:.3f} ms; library {}'.format(
                  name, tuple(k['shape']),
                  _spread(k) if 'ms_min' in k else '{:.4f} ms'.format(
                      k['ms']),
                  100 * k['bound_ms'] / k['ms'], k['bound_ms'],
                  k['bound_by'], k['plain_ms'],
                  'torch._int_mm(X, X.T) {:.4f} ms'.format(k['library_ms'])
                  if k['library_ms'] else 'none'))
    return k1, k2


WIDE_BOOT_ROT = 4    # rotated time-axis runs on the wide record: cut for
WIDE_BOOT_SPACE = 2  # time only, as the space-axis runs


def _wide_boot(torch, ms, passes, n_runs, **kw):
    """One ``bootstrapping(n_runs, n_modes=N_ROT, block_size=BOOT_BLOCK,
    seed=SEED, **kw)`` of the wide model: ``(result, wall, passes a field,
    pass walls, peak GB above the resident, resident GB)``; the peak
    device memory in all must stay below the card's."""
    before = {k: len(v) for k, v in passes.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    got = _timed(torch, walls, 'run', lambda: _vals(ms.bootstrapping(
        n_runs, n_modes=N_ROT, block_size=BOOT_BLOCK, seed=SEED, **kw)))
    top = torch.cuda.max_memory_allocated()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    _check(top < card_bytes, 'the wide bootstrap took {:.2f} GB of the '
           'card\'s {:.2f} GB'.format(top / 1e9, card_bytes / 1e9))
    counts, pass_walls = _field_passes(passes, before)
    return got, walls['run'], counts, pass_walls, (top - base) / 1e9, \
        base / 1e9


def _print_wide_boot(label, n_runs, wall, counts, pass_walls, gb, peak, base,
                     card, line):
    print('{} ({} runs) at {} x 2 x {} f32: {:.3f} s, {:.3f} s a run; '
          'passes a field {}; peak device memory {:.2f} GB above the {:.2f} '
          'GB resident; {}; {}'.format(
              label, n_runs, N_OBS, WIDE_TILES * WIDE_LAT * WIDE_LON, wall,
              wall / n_runs, counts, peak, base, line, card))
    _print_boot_passes(label, pass_walls, gb)


def wide_boot_time(torch, ms, grams_b, gram_err, H, p, passes, gb, card):
    """``bootstrapping(N_BOOT, n_modes=10)`` of the unrotated wide model:
    the time axis in Gram space, no pass over the data; each run against
    the same n x n reduction of 25 x B's Gram (its own indices and start
    block), modes 1-N_EOF_MODES within 1e-4 and every mode within
    max(1e-4, the run's condition number x the Grams' difference), the
    bounds of the wide solve."""
    import numpy as np
    label = 'wide_stream_path bootstrap, unrotated time axis'
    got, wall, counts, pass_walls, peak, base = _wide_boot(
        torch, ms, passes, N_BOOT)
    ref, kappa = _wide_axis0_reference(
        torch, [WIDE_TILES * g for g in grams_b], p, H, ms._subspace_iters)
    err = np.abs(got.T / ref - 1)
    bound = np.maximum(1e-4, kappa * gram_err)
    _print_wide_boot(label, N_BOOT, wall, counts, pass_walls, gb, peak, base,
                     card, 'against the n x n reduction of {} x B\'s '
                     'resampled Gram: modes 1-{} rel {:.2e} (tol 1e-4), each '
                     'mode\'s max over the runs {} (tol per run: max(1e-4, '
                     'condition number {:.3e}-{:.3e} x {:.2e}))'.format(
                         WIDE_TILES, N_EOF_MODES,
                         err[:, :N_EOF_MODES].max(),
                         np.array2string(err.max(axis=0), precision=2),
                         kappa.min(), kappa.max(), gram_err))
    _check(counts == {'left': 0, 'right': 0},
           '{}: passes {} (expected none)'.format(label, counts))
    _check(np.isfinite(got).all() and (_kept(got) == N_BOOT).all(),
           '{}: runs kept {}'.format(label, _kept(got).tolist()))
    _check(err[:, :N_EOF_MODES].max() <= 1e-4
           and (err.max(axis=1) <= bound).all(),
           '{}: differs from 25 x B\'s reduction: {}'.format(label, err))


def wide_boot_rotated(torch, ms, mb, passes, gb, card):
    """``bootstrapping(WIDE_BOOT_ROT, n_modes=10)`` of the rotated wide
    model in one batch (``set_solver(batch_size=4)``), runs rotated to
    tol 1e-8 (the f32 floor): one projection pass a field.  Reference: B's
    own tile projected against the same runs' weights (caught as the
    bootstrap hands them to its projection).  The wide loading stack is
    25 copies of the tile's, each row times +-1: the varimax criterion is
    invariant to a row's sign and 25 times the tile's, so the rotation is
    the tile's, each column norm sqrt(25) times the tile's, and the
    variance (left norm x right norm) 25 times the tile's.  Under each
    run's own rotation matrix (caught) modes 1-N_EOF_MODES within 1e-4;
    the tile rotated on its own within ROT_STOP_TOL (its stopping point
    moves with roundoff)."""
    import numpy as np
    from xmca_tpu_torch.core import fastpath as fp
    from xmca_tpu_torch.stats import streaming_boot as sb
    label = 'wide_stream_path bootstrap, rotated time axis'
    tol = ms._ensemble_tol
    ms.set_solver(batch_size=WIDE_BOOT_ROT, ensemble_tol=1e-8)
    caught, rots = [], []
    restore = [_catch(sb, '_project_and_rotate', caught),
               _rotation_matrices(rots)]
    got, wall, counts, pass_walls, peak, base = _wide_boot(
        torch, ms, passes, WIDE_BOOT_ROT)
    for put_back in restore:
        put_back()
    (su, s_b, Y_b), _ = caught[0]
    tile = WIDE_LAT * WIDE_LON
    fixed, own = [], []
    for r, s in enumerate(s_b):
        V = [fp.combine_analytic_projection(mb._fields[k].T @ Y_b[k][r])
             for k in ('left', 'right')]
        L = torch.cat(V) * torch.sqrt(s).to(V[0].dtype)[None, :]
        fixed.append(WIDE_TILES * _variance_with(torch, L, tile, rots[r]))
        v, _, _ = fp._rotated_variance(V[0], V[1], s, su.power, su.tol,
                                       'ns-gated')
        own.append(WIDE_TILES * v)
    errs = [np.abs(got.T / torch.stack(r).cpu().numpy() - 1)
            for r in (fixed, own)]
    _print_wide_boot(label, WIDE_BOOT_ROT, wall, counts, pass_walls, gb,
                     peak, base, card, 'against {} x the variance of B\'s '
                     'tile under each run\'s rotation: per mode rel {} '
                     '(modes 1-{} tol 1e-4); against {} x the tile rotated '
                     'on its own: {} (tol {:g})'.format(
                         WIDE_TILES, np.array2string(errs[0].max(axis=0),
                                                     precision=2),
                         N_EOF_MODES, WIDE_TILES,
                         np.array2string(errs[1].max(axis=0), precision=2),
                         ROT_STOP_TOL))
    _check(counts == {'left': 1, 'right': 1},
           '{}: passes {} (expected 1 a field)'.format(label, counts))
    _check(len(caught) == 1 and len(rots) == WIDE_BOOT_ROT
           and np.isfinite(got).all()
           and (_kept(got) == WIDE_BOOT_ROT).all(),
           '{}: batches {}, runs kept {}'.format(label, len(caught),
                                                 _kept(got).tolist()))
    _check(errs[0][:, :N_EOF_MODES].max() <= 1e-4
           and errs[1][:, :N_EOF_MODES].max() <= ROT_STOP_TOL,
           '{}: differs from 25 x the tile\'s: {}'.format(label, errs))
    ms._ensemble_tol = tol


def wide_boot_space(torch, ms, mb, passes, gb, card):
    """``bootstrapping(WIDE_BOOT_SPACE, n_modes=10, axis=1, on_left=True,
    on_right=True)`` of the rotated wide model: a counts pass and a
    projection pass a field.  Each run's counts-weighted Gram (caught as
    the counts pass returns it) against the in-memory ``sum_j B_n
    diag(c_rj) B_n^T`` of its counts (tile j's are c_rj; the signs drop
    out, so it is ``B_n diag(sum_j c_rj) B_n^T`` for each field), rel
    Frobenius within 1e-5."""
    import numpy as np
    from xmca_tpu_torch.stats import streaming_boot as sb
    label = 'wide_stream_path bootstrap, space axis (both fields)'
    tile = WIDE_LAT * WIDE_LON
    p = WIDE_TILES * tile
    caught = []
    restore = _catch(sb, '_counts_gram_pass', caught)
    got, wall, counts, pass_walls, peak, base = _wide_boot(
        torch, ms, passes, WIDE_BOOT_SPACE, axis=1, on_left=True,
        on_right=True)
    restore()
    (_, _, c), G = caught[0]
    errs = []
    for r in range(c.shape[0]):
        ref = sum((B * c[r, f * p:(f + 1) * p].view(WIDE_TILES, tile)
                   .sum(dim=0)) @ B.T
                  for f, B in enumerate((mb._fields['left'],
                                         mb._fields['right'])))
        errs.append(float(torch.linalg.norm(G[r] - ref)
                          / torch.linalg.norm(ref)))
    _print_wide_boot(label, WIDE_BOOT_SPACE, wall, counts, pass_walls, gb,
                     peak, base, card, 'each counts-weighted Gram (the left '
                     'and the right resample of each run) vs sum_j B_n '
                     'diag(c_rj) B_n^T rel Frobenius {} (tol 1e-5); rotated '
                     'variance {}'.format(
                         np.array2string(np.asarray(errs), precision=2),
                         np.array2string(got[:, 0], precision=4)))
    _check(counts == {'left': 2, 'right': 2},
           '{}: passes {} (expected 2 a field)'.format(label, counts))
    _check(len(caught) == 1 and len(errs) == 2 * WIDE_BOOT_SPACE
           and max(errs) <= 1e-5,
           '{}: counts-weighted Grams differ: {}'.format(label, errs))
    _check(np.isfinite(got).all() and (_kept(got) == WIDE_BOOT_SPACE).all(),
           '{}: runs kept {}'.format(label, _kept(got).tolist()))


def _small_pair(torch, build):
    """``build(device)`` on the card and on the CPU: singular values (tol
    1e-4), rotated variance (1e-3) and the null q95 (2e-2) of rule_n(8),
    the small path's bounds."""
    import numpy as np
    out = {}
    for device in ('cuda', 'cpu'):
        mm = build(device)
        out[device] = (_vals(mm.singular_values()), _vals(mm.variance()),
                       np.quantile(_vals(mm.rule_n(8, seed=SEED)), 0.95,
                                   axis=1))
    return [float(np.abs(a / b - 1).max())
            for a, b in zip(out['cuda'], out['cpu'])]


def _small_models(torch, label, cases):
    """``cases`` of (kind, extend) at 256 x 2 x 512 (monthly: period 12)
    on the card and on the CPU: in-memory models or chunk-backed ones
    (100-column chunks)."""
    from xmca_tpu_torch.xarray import xMCA
    left, right = make_fields(256, 16, 32, seed0=81)
    coords = {d: _vals(left.coords[d]) for d in ('time', 'lat', 'lon')}
    arrays = [_vals(f).reshape(256, -1) for f in (left, right)]
    errs = {}
    for kind, extend in cases:
        def build(device):
            if kind == 'streamed':
                mm = xMCA.from_chunks(*[_host_loader(torch, a, 100)
                                        for a in arrays], coords=coords,
                                      device=device)
            else:
                mm = xMCA(left, right, device=device)
            mm.set_solver(truncate=4)
            mm.normalize()
            mm.apply_coslat()
            mm.solve(complexify=True, extend=extend, period=12)
            mm.rotate(4)
            return mm
        errs['{} {}'.format(kind, extend or 'plain')] = _small_pair(torch,
                                                                    build)
    print('{} card vs CPU at 256 x 2 x 512, rel singular values / rotated '
          'variance / null q95 of rule_n(8) (tol 1e-4 / 1e-3 / 2e-2): {}'
          .format(label, ', '.join('{} {:.1e} / {:.1e} / {:.1e}'.format(
              k, *v) for k, v in errs.items())))
    _check(all(v[0] <= 1e-4 and v[1] <= 1e-3 and v[2] <= 2e-2
               for v in errs.values()),
           '{}: card and CPU disagree'.format(label))


def extend_small(torch):
    """Extended in-memory models small, 'exp' and 'theta', card vs CPU."""
    _small_models(torch, 'extend_small', [('in memory', 'exp'),
                                          ('in memory', 'theta')])


def stream_small(torch):
    """Chunk-backed models small, plain and 'exp', card vs CPU."""
    _small_models(torch, 'stream_small', [('streamed', False),
                                          ('streamed', 'exp')])


# ---------------------------------------------------------------- mesh_path
MESH_SHAPE = (2, 2)       # (ensemble, space): four ranks on the one card
N_MESH_RUNS = 16          # rule_n on the mesh models: cut for time only
N_MESH_RUNS_PM = 8        # rule_n after promax: cut for time only
N_MESH_RUNS_GEN = 4       # 'normal16' rule_n (the field kernel): cut for
                          # time only
N_MESH_BOOT = 4           # bootstrap runs: cut for time only
N_MESH_BOOT_NEW = 4       # runs of the column resample and of the runs
                          # split over the space axis: cut for time only
MESH_COL_BLOCK = N_LON    # the column resample's block: one latitude row
                          # of the grid (divides the packed 2 x 100000)
MESH_TIMEOUT_S = 600      # the ranks' process-group timeout and wall limit
# the bootstrap phases a mesh flow measures on their own: their walls,
# collectives and peak device memory above what was resident before them
MESH_PHASES = ('bootstrapping axis=1', 'bootstrapping ensemble_axis=space')
_PEAK = {'seen': 0}       # the largest device peak of a flow, across the
                          # resets of its measured phases


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def mesh_flow(torch, left, right, mesh, folder):
    """``__graft_entry__.dryrun_multichip``'s public flow at the main
    path's width on ``mesh`` (None: the unsharded model): ``set_solver(
    truncate=10, mesh)`` -> ``normalize`` -> ``apply_coslat`` ->
    ``solve(complexify=True)`` -> ``rotate(10)`` -> ``rule_n(16)`` (and
    ``rule_n(4)`` of 'normal16' fields, the field kernel's); the
    spectrum, EOFs, PCs and rotated variance; ``bootstrapping(4)`` (tol
    1e-8); ``rotate(10, power=4)`` -> ``rule_n(8)``; the array-level
    save (``info.xmca`` by the writing rank) and load into a fresh model on
    the same mesh; ``MCA.from_chunks`` over 16384-column chunks ->
    ``solve(complexify=True)`` -> ``bootstrapping(4)``; between the first
    bootstrap and the promax, ``bootstrapping(4, axis=1)`` of both fields
    in blocks of one grid row and ``bootstrapping(4)`` with its runs split
    over the 'space' axis (MESH_PHASES).  Returns ``(results, walls,
    launches, phases)``: host arrays, host seconds per stage (each ending
    in a device synchronize), the kernel launches of each ``rule_n``, and
    each of MESH_PHASES' collectives, bytes and peak device memory above
    the memory allocated before it."""
    import os
    import numpy as np
    from xmca_tpu_torch.api.array import MCA
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.parallel import mesh as pmesh
    from xmca_tpu_torch.xarray import xMCA
    walls, launches, out = {}, {}, {}

    def stage(name, fn):
        return _timed(torch, walls, name, fn)

    def counted(name, fn):
        _build.reset_launch_counts()
        res = stage(name, fn)
        launches[name] = _counts(_build.launch_counts())
        return res

    phases = {}

    def measured(name, fn):
        coll = pmesh.collective_counts()
        _PEAK['seen'] = max(_PEAK['seen'], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _build.reset_launch_counts()
        res = stage(name, fn)
        now = pmesh.collective_counts()
        phases[name] = {
            'collectives': now.get('all_reduce', 0) - coll.get('all_reduce',
                                                               0),
            'bytes': now.get('bytes', 0) - coll.get('bytes', 0),
            'peak_gb': (torch.cuda.max_memory_allocated() - before) / 1e9,
            'launches': _counts(_build.launch_counts())}
        return res

    m = stage('ingest', lambda: xMCA(left, right, device='cuda'))
    m.set_solver(truncate=N_ROT, mesh=mesh)
    m.normalize()
    m.apply_coslat()
    stage('solve', lambda: m.solve(complexify=True))
    stage('rotate', lambda: m.rotate(N_ROT))
    out['null'] = counted('rule_n', lambda: _vals(m.rule_n(N_MESH_RUNS,
                                                          seed=SEED)))
    m.set_solver(surrogate_gen_dist='normal16')
    out['null_gen'] = counted('rule_n normal16', lambda: _vals(
        m.rule_n(N_MESH_RUNS_GEN, seed=SEED)))
    m.set_solver(surrogate_gen_dist='rademacher8')
    out['svals'] = _vals(m.singular_values(N_ROT))
    out['expvar'] = _vals(m.explained_variance(N_ROT))
    out['var_sum'] = float(_vals(m.variance()).sum())
    out['eofs'] = {k: _vals(v) for k, v in m.eofs(N_ROT,
                                                  rotated=False).items()}
    out['eofs_rot'] = {k: _vals(v) for k, v in m.eofs(N_ROT).items()}
    out['pcs'] = {k: _vals(v) for k, v in m.pcs(N_ROT).items()}
    m.set_solver(ensemble_tol=1e-8)
    out['boot'] = stage('bootstrapping', lambda: _vals(m.bootstrapping(
        N_MESH_BOOT, n_modes=N_ROT, block_size=BOOT_BLOCK, seed=SEED)))
    out['boot_axis1'] = measured(MESH_PHASES[0], lambda: _vals(
        m.bootstrapping(N_MESH_BOOT_NEW, n_modes=N_ROT, axis=1,
                        on_left=True, on_right=True,
                        block_size=MESH_COL_BLOCK, seed=SEED)))
    m.set_solver(ensemble_axis=pmesh.SPACE_AXIS)
    out['boot_space'] = measured(MESH_PHASES[1], lambda: _vals(
        m.bootstrapping(N_MESH_BOOT_NEW, n_modes=N_ROT,
                        block_size=BOOT_BLOCK, seed=SEED)))
    m.set_solver(ensemble_axis=pmesh.ENSEMBLE_AXIS)
    stage('rotate power=4', lambda: m.rotate(N_ROT, power=4))
    out['expvar_pm'] = _vals(m.explained_variance(N_ROT))
    out['var_sum_pm'] = float(_vals(m.variance()).sum())
    out['null_pm'] = counted('rule_n power=4', lambda: _vals(
        m.rule_n(N_MESH_RUNS_PM, seed=SEED)))

    def save():
        if pmesh.is_writer(mesh):
            m._create_info_file(folder)
        pmesh.barrier(mesh)
        fields = m.fields(original_scale=True)
        return ({k: np.ascontiguousarray(_vals(f).real)
                 for k, f in fields.items()},
                {k: _vals(e) for k, e in m.eofs(rotated=False).items()},
                _vals(m.singular_values()), fields)
    fields, eofs, svals, das = stage('save (the arrays)', save)

    def load():
        lm = xMCA(device='cuda')
        lm.set_solver(mesh=mesh)
        lm._field_coords = {k: da.coords for k, da in das.items()}
        lm._field_dims = {k: da.dims for k, da in das.items()}
        MCA.load_analysis(lm, os.path.join(folder, 'info.xmca'),
                          fields=fields, eofs=eofs, singular_values=svals)
        if lm._analysis['is_coslat_corrected']:
            lm.apply_coslat()
        return lm
    lm = stage('load', load)
    out['loaded_svals'] = _vals(lm.singular_values(N_ROT))
    out['loaded_eofs'] = {k: _vals(v) for k, v in lm.eofs(
        N_ROT, rotated=False).items()}
    del lm, m, fields, das
    torch.cuda.empty_cache()

    arrays = [np.asarray(f.values).reshape(N_OBS, -1) for f in (left, right)]
    mc = MCA.from_chunks(
        *[_host_loader(torch, a, STREAM_CHUNKS[0]) for a in arrays],
        n_observations=N_OBS, left_shape=(N_LAT, N_LON),
        right_shape=(N_LAT, N_LON), device='cuda')
    mc.set_solver(truncate=N_ROT, mesh=mesh)
    stage('streamed solve', lambda: mc.solve(complexify=True))
    out['stream_svals'] = _vals(mc.singular_values(N_ROT))
    out['stream_eofs'] = {k: _vals(v) for k, v in mc.eofs(
        N_ROT, rotated=False).items()}
    out['stream_boot'] = stage('streamed bootstrapping', lambda: _vals(
        mc.bootstrapping(N_MESH_BOOT, n_modes=N_ROT, block_size=BOOT_BLOCK,
                         seed=SEED)))
    del mc
    torch.cuda.empty_cache()
    return out, walls, launches, phases


def _flat(out):
    """``(name, array)`` pairs of every result of :func:`mesh_flow`."""
    import numpy as np
    for k, v in out.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                yield '{}[{}]'.format(k, kk), np.asarray(vv)
        else:
            yield k, np.asarray(v)


def _per_run(label, walls):
    """Walls of a mesh flow with rule_n and bootstrapping per run."""
    w = dict(walls)
    w['rule_n a run'] = w.pop('rule_n') / N_MESH_RUNS
    w['rule_n normal16 a run'] = w.pop('rule_n normal16') / N_MESH_RUNS_GEN
    w['rule_n power=4 a run'] = w.pop('rule_n power=4') / N_MESH_RUNS_PM
    w['bootstrapping a run'] = w.pop('bootstrapping') / N_MESH_BOOT
    for name in MESH_PHASES:
        w[name + ' a run'] = w.pop(name) / N_MESH_BOOT_NEW
    w['streamed bootstrapping a run'] = (w.pop('streamed bootstrapping')
                                         / N_MESH_BOOT)
    _print_walls(label, w)


def _mesh_vs(got, ref):
    """A sharded flow's results against the unsharded one's, as
    ``_stream_vs`` holds a chunk-backed model to an in-memory one: the
    spectra (modes 1-N_EOF_MODES relative to the largest), unrotated EOFs
    (aligned, modes 1-N_EOF_MODES), the rotated explained variance per
    mode, the Rule-N nulls over the ratio of the rescaling totals, the
    bootstrap spectra run for run per mode, and the loaded model's
    spectrum and EOFs against its saved model's (max abs difference)."""
    import numpy as np
    k = N_EOF_MODES

    def spectrum(a, b):
        return _rel(np.asarray(a)[:k], np.asarray(b)[:k])

    def eofs(a, b):
        return max(_rel(_align(a[f][..., :k], b[f][..., :k]),
                        b[f][..., :k]) for f in b)

    def per_mode(a, b):
        return float(np.abs(np.asarray(a)[:k] / np.asarray(b)[:k] - 1).max())

    def null(a, b, scale):
        if a.shape != b.shape:
            return float('inf')
        return float(np.abs(a / (b * scale) - 1).max())

    def exact(a, b):
        return max(float(np.nanmax(np.abs(a[f] - b[f]))) for f in b)

    def boot(a, b):
        if not np.array_equal(a == 0, b == 0):
            return float('inf')
        r = np.where(b != 0, np.abs(a / np.where(b != 0, b, 1) - 1), 0)
        return float(r[:k].max())

    return {
        'svals': spectrum(got['svals'], ref['svals']),
        'eofs': eofs(got['eofs'], ref['eofs']),
        'variance': per_mode(got['expvar'], ref['expvar']),
        'null': null(got['null'], ref['null'],
                     got['var_sum'] / ref['var_sum']),
        'null normal16': null(got['null_gen'], ref['null_gen'],
                              got['var_sum'] / ref['var_sum']),
        'boot': boot(got['boot'], ref['boot']),
        'boot axis=1': boot(got['boot_axis1'], ref['boot_axis1']),
        'boot ensemble_axis=space': boot(got['boot_space'],
                                         ref['boot_space']),
        'variance power=4': per_mode(got['expvar_pm'], ref['expvar_pm']),
        'null power=4': null(got['null_pm'], ref['null_pm'],
                             got['var_sum_pm'] / ref['var_sum_pm']),
        'loaded svals': spectrum(got['loaded_svals'], got['svals']),
        'loaded eofs': exact(got['loaded_eofs'], got['eofs']),
        'streamed svals': spectrum(got['stream_svals'],
                                   ref['stream_svals']),
        'streamed eofs': eofs(got['stream_eofs'], ref['stream_eofs']),
        'streamed boot': boot(got['stream_boot'], ref['stream_boot']),
    }


# the (2, 2) ranks' gates: _stream_vs's f32 gates for a changed summation
# order (STREAM_TOL), the rotated variance and each rotated bootstrap run
# per mode at ROT_STOP_TOL, the loaded model exactly as saveload_path
MESH_TOL = {'svals': STREAM_TOL['svals'], 'eofs': STREAM_TOL['eofs'],
            'variance': ROT_STOP_TOL, 'null': STREAM_TOL['null'],
            'null normal16': STREAM_TOL['null'],
            'boot': ROT_STOP_TOL, 'boot axis=1': ROT_STOP_TOL,
            'boot ensemble_axis=space': ROT_STOP_TOL,
            'variance power=4': ROT_STOP_TOL,
            'null power=4': STREAM_TOL['null'], 'loaded svals': 0.0,
            'loaded eofs': 0.0, 'streamed svals': STREAM_TOL['svals'],
            'streamed eofs': STREAM_TOL['eofs'],
            'streamed boot': STREAM_TOL['svals']}


# the results every (2, 2) rank pickles (rank 0 pickles all of them)
_EVERY_RANK = ('svals', 'null', 'boot', 'boot_axis1', 'boot_space',
               'stream_svals')


def _peak_reset(torch):
    torch.cuda.reset_peak_memory_stats()
    _PEAK['seen'] = 0


def _peak(torch):
    """The device's peak allocation since :func:`_peak_reset`, across the
    resets of mesh_flow's measured phases."""
    return max(torch.cuda.max_memory_allocated(), _PEAK['seen'])


def _print_phases(label, phases, walls):
    """Each of MESH_PHASES' wall a run, collectives, bytes and peak."""
    for name in MESH_PHASES:
        ph = phases[name]
        print('mesh_path {} {}({}): {:.4f} s a run, {} collectives, {:.4f} '
              'GB reduced, peak +{:.2f} GB above the resident, launches {}'
              .format(label, name, N_MESH_BOOT_NEW,
                      walls[name] / N_MESH_BOOT_NEW, ph['collectives'],
                      ph['bytes'] / 1e9, ph['peak_gb'],
                      {k: v for k, v in ph['launches'].items() if v}))
        _check(not any(ph['launches'].values()),
               'mesh_path {}: {} launched {}'.format(label, name,
                                                     ph['launches']))


def mesh_rank_main(rank, port, folder):
    """One rank of mesh_path's (2, 2) mesh: a gloo process group of four
    ranks on the card, the flow on its shards, its results pickled to
    ``folder`` (all of them on rank 0; walls, launches, collectives and
    peak memory on every rank).  Builds nothing: the parent built the
    kernels."""
    import os
    import pickle
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    from xmca_tpu_torch.parallel import mesh as pmesh
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method='tcp://localhost:%d' % port,
                            world_size=MESH_SHAPE[0] * MESH_SHAPE[1],
                            rank=rank,
                            timeout=timedelta(seconds=MESH_TIMEOUT_S))
    mesh = pmesh.make_mesh(*MESH_SHAPE)
    left, right = make_fields(N_OBS, N_LAT, N_LON)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    _peak_reset(torch)
    pmesh.reset_collective_counts()
    out, walls, launches, phases = mesh_flow(torch, left, right, mesh, folder)
    res = {'walls': walls, 'launches': launches, 'phases': phases,
           'collectives': pmesh.collective_counts(),
           'peak_gb': (_peak(torch) - base) / 1e9,
           'coordinate': (pmesh.axis_rank(mesh, 'ensemble'),
                          pmesh.axis_rank(mesh, 'space')),
           'out': out if rank == 0 else {
               k: out[k] for k in _EVERY_RANK}}
    with open(os.path.join(folder, 'rank%d.pkl' % rank), 'wb') as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def _mesh_ranks(folder):
    """Run the (2, 2) ranks as four processes of this script; any rank's
    failure, or the wall limit, fails the smoke."""
    import pickle
    import os
    port = _free_port()
    n = MESH_SHAPE[0] * MESH_SHAPE[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               '--mesh-rank', str(r), str(port), folder])
             for r in range(n)]
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    _check(all(c == 0 for c in codes),
           'mesh_path: the (2, 2) ranks exited with {}'.format(codes))
    ranks = []
    for r in range(n):
        with open(os.path.join(folder, 'rank%d.pkl' % r), 'rb') as f:
            ranks.append(pickle.load(f))
    return ranks


def mesh_path(torch, left, right, card):
    """The device mesh (``xmca_tpu_torch.parallel``) on the one card:
    (a) a world of one rank (NCCL, mesh (1, 1)) in this process, every
    result of :func:`mesh_flow` equal bit for bit to the unsharded flow's
    (a size-1 axis communicates nothing), with exactly 2 x 16 and 2 x 8
    launches of syrk and sign_field_sums and 2 x 4 of surrogate_field;
    (b) four ranks sharing the card over gloo, mesh (2, 2), each holding
    half of each field's columns, held to the unsharded flow by MESH_TOL,
    with exactly 2 x 8 and 2 x 4 launches of syrk and sign_field_sums and
    2 x 2 of surrogate_field a rank (each run whole on its rank, the two
    space ranks of an ensemble group running the same runs).  The flow's
    column resample and its runs split over the space axis are held the
    same way, each of them printed with its wall a run, collectives,
    bytes and peak memory (MESH_PHASES).  One card shows the sharded
    arithmetic and each rank's cost, not scaling."""
    import os
    import shutil
    import tempfile
    from datetime import timedelta
    import numpy as np
    import torch.distributed as dist
    from xmca_tpu_torch.ops import _build
    from xmca_tpu_torch.parallel import mesh as pmesh
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix='mesh_', dir=_build.BUILD_DIR)
    folders = {k: os.path.join(root, k) for k in ('ref', 'one', 'ranks')}
    for f in folders.values():
        os.makedirs(f)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    _peak_reset(torch)
    ref, ref_walls, ref_launches, ref_phases = mesh_flow(
        torch, left, right, None, folders['ref'])
    ref_peak = (_peak(torch) - base) / 1e9

    dist.init_process_group('nccl', init_method='tcp://localhost:%d'
                            % _free_port(), world_size=1, rank=0,
                            timeout=timedelta(seconds=MESH_TIMEOUT_S))
    one = pmesh.make_mesh(1, 1)
    pmesh.reset_collective_counts()
    _peak_reset(torch)
    got, walls, launches, phases = mesh_flow(torch, left, right, one,
                                             folders['one'])
    one_peak = (_peak(torch) - base) / 1e9
    one_coll = pmesh.collective_counts()
    dist.destroy_process_group()
    unequal = [name for (name, a), (_, b) in zip(_flat(got), _flat(ref))
               if not np.array_equal(a, b, equal_nan=True)]
    _per_run('mesh_path unsharded flow at {} x 2 x {} f32 (peak +{:.2f} GB); '
             '{}'.format(N_OBS, N_LAT * N_LON, ref_peak, card), ref_walls)
    _per_run('mesh_path (a) world of one, NCCL, mesh (1, 1) (peak +{:.2f} '
             'GB, collectives {})'.format(one_peak, one_coll), walls)
    _print_phases('unsharded', ref_phases, ref_walls)
    _print_phases('(a)', phases, walls)
    print('mesh_path (a): launches {} (unsharded {}); results unequal to '
          'the unsharded flow: {}'.format(launches, ref_launches,
                                          unequal or 'none'))
    _check(not unequal, 'mesh_path (a): the (1, 1) mesh differs from the '
           'unsharded model in {}'.format(unequal))
    for name, n_runs in (('rule_n', N_MESH_RUNS),
                         ('rule_n power=4', N_MESH_RUNS_PM)):
        lc = launches[name]
        _check(lc['syrk'] == lc['sign_field_sums'] == 2 * n_runs,
               'mesh_path (a): {} launched {}'.format(name, lc))
    lc = launches['rule_n normal16']
    _check(lc['surrogate_field'] == 2 * N_MESH_RUNS_GEN and lc['syrk'] == 0,
           'mesh_path (a): rule_n normal16 launched {}'.format(lc))

    t0 = time.perf_counter()
    ranks = _mesh_ranks(folders['ranks'])
    wall = time.perf_counter() - t0
    errs = _mesh_vs(ranks[0]['out'], ref)
    for r, res in enumerate(ranks):
        _per_run('mesh_path (b) rank {} at {} of mesh {} over gloo (peak '
                 '+{:.2f} GB; collectives {}, launches {})'.format(
                     r, res['coordinate'], MESH_SHAPE, res['peak_gb'],
                     res['collectives'], res['launches']), res['walls'])
        _print_phases('(b) rank {}'.format(r), res['phases'], res['walls'])
    print('mesh_path (b): 4 ranks in {:.1f} s (spawn, fields and flow); '
          'against the unsharded flow: {}'.format(wall, ', '.join(
              '{} {:.2e} (tol {:g})'.format(k, v, MESH_TOL[k])
              for k, v in errs.items())))
    bad = {k: v for k, v in errs.items() if not v <= MESH_TOL[k]}
    _check(not bad, 'mesh_path (b): the (2, 2) mesh is off: {}'.format(bad))
    for r, res in enumerate(ranks):
        for k in _EVERY_RANK:
            _check(np.array_equal(res['out'][k], ranks[0]['out'][k]),
                   'mesh_path (b): rank {} disagrees on {}'.format(r, k))
        for name, n_runs in (('rule_n', N_MESH_RUNS),
                             ('rule_n power=4', N_MESH_RUNS_PM)):
            lc = res['launches'][name]
            share = n_runs // MESH_SHAPE[0]
            _check(lc['syrk'] == lc['sign_field_sums'] == 2 * share,
                   'mesh_path (b): rank {} {} launched {} (expected 2 x {})'
                   .format(r, name, lc, share))
        lc = res['launches']['rule_n normal16']
        _check(lc['surrogate_field'] == 2 * N_MESH_RUNS_GEN // MESH_SHAPE[0]
               and lc['syrk'] == 0, 'mesh_path (b): rank {} rule_n '
               'normal16 launched {}'.format(r, lc))
    shutil.rmtree(root)
    return {'ref': ref_walls, 'one': walls, 'ranks': ranks}


def main():
    import torch
    if not torch.cuda.is_available():
        _fail('no CUDA device (torch.cuda.is_available() is False)')
    import numpy as np
    from xmca_tpu_torch.ops import _build

    card = _card_line()
    t0 = time.perf_counter()
    _build.library()
    print('kernels built in {:.1f} s (nvcc, sm_90a)'.format(
        time.perf_counter() - t0))
    # -Xptxas -v: each kernel's registers, static shared memory, spills
    for line in _build.build_log().splitlines():
        if any(k in line for k in ('entry function', 'registers', 'spill',
                                   'wgmma')):
            print('  ' + line.strip())
    print('syrk: {} bytes of dynamic shared memory a block'.format(
        _build.library().xmca_syrk_smem_bytes()))
    clock = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(clock.stdout.strip().splitlines()[0])
    ISSUE['lanes_per_s'] = SM_ISSUE_LANES * mhz * 1e6
    print('Philox4x32-10: {} SASS instructions a call in this build '
          '(constant {}, counted 2026-10-16); SM clock max {:.0f} MHz: '
          'issue rate {:.3e} lane-instructions/s'.format(
              philox_sass_per_call(), PHILOX_SASS_PER_CALL, mhz,
              ISSUE['lanes_per_s']))
    print('card: {} | torch {} | CUDA {} | allow_tf32 matmul={} cudnn={}'
          .format(card, torch.__version__, torch.version.cuda,
                  torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32))

    k1 = check_syrk(torch)
    k2 = check_sign_field(torch)
    k5 = check_surrogate_field(torch)
    k3 = check_surrogate_gram(torch)
    k4 = check_surrogate_project(torch)
    k6 = check_ses(torch)
    k7 = check_pm1_project(torch)

    left, right = make_fields(N_OBS, N_LAT, N_LON)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    _build.reset_launch_counts()
    m, null = workload(torch, left, right, 'cuda', N_RUNS, N_ROT, walls)
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    null = np.asarray(null)
    var = np.asarray(m.variance(N_ROT))
    iters = m._rule_n_iterations
    q95 = np.quantile(null, 0.95, axis=1)
    print('main path at {} x 2 x {} f32, N={}: ingest {:.3f} s, solve '
          '{:.3f} s, rotate {:.3f} s, rule_n {:.3f} s ({:.4f} s/run)'
          .format(N_OBS, N_LAT * N_LON, N_RUNS, walls['ingest'],
                  walls['solve'], walls['rotate'], walls['rule_n'],
                  walls['rule_n'] / N_RUNS))
    print('launches {}; rotate varimax iterations {}; rule_n iterations '
          'min/median/max {}/{}/{}; peak device memory {:.2f} GB'.format(
              launches, m._rotate_iterations, iters.min(),
              int(np.median(iters)), iters.max(), peak_gb))
    print('rotated variance {}'.format(np.array2string(var, precision=4)))
    print('null q95 {}'.format(np.array2string(q95, precision=4)))
    _launch_gate('main path', launches, N_RUNS)
    _check(null.shape[0] == N_ROT and null.shape[1] >= int(0.9 * N_RUNS),
           'Rule-N kept {} of {} runs'.format(null.shape[1], N_RUNS))
    _check(np.isfinite(null).all() and np.isfinite(var).all(),
           'non-finite results')

    project_blocks(torch, m)
    result_path(torch, m)
    dense_path(torch, left, right, m)
    boot_path(torch, m, card)
    saveload_path(torch, m, left, right, card)
    ens = ensemble_path(torch, m, null, card)
    m_exp, ext_ses = extend_path(torch, left, right, card)
    stream_peak, ms, arrays = stream_path(torch, m, m_exp, left, right, card)
    stream_boot_path(torch, ms, m, arrays, card)
    del m, m_exp, ms, arrays
    torch.cuda.empty_cache()
    mesh_path(torch, left, right, card)
    del left, right
    torch.cuda.empty_cache()

    # the same path small, on the card and on the CPU (plain versions,
    # same random bits): f32 roundoff through Cholesky, the subspace
    # iteration and the rotation fixed points
    small_l, small_r = make_fields(256, 16, 32, seed0=11)
    mg, ng = workload(torch, small_l, small_r, 'cuda', 16, 4)
    mc, nc = workload(torch, small_l, small_r, 'cpu', 16, 4)
    sv_err = np.max(np.abs(mg.singular_values().values
                           / mc.singular_values().values - 1))
    var_err = np.max(np.abs(mg.variance().values / mc.variance().values
                            - 1))
    q_err = np.max(np.abs(np.quantile(ng, 0.95, axis=1)
                          / np.quantile(nc, 0.95, axis=1) - 1))
    print('small path card vs CPU: svals rel {:.2e} (tol 1e-4), rotated '
          'variance rel {:.2e} (tol 1e-3), null q95 rel {:.2e} (tol 2e-2)'
          .format(sv_err, var_err, q_err))
    _check(sv_err <= 1e-4 and var_err <= 1e-3 and q_err <= 2e-2,
           'card and CPU disagree on the small path')
    small_results(torch)
    int_fields_small(torch)

    gen_launches = gen_path(torch)
    gen_small(torch)
    boot_small(torch)
    fast_vs_exact(torch, card)
    ensemble_small(torch)
    extend_small(torch)
    stream_small(torch)
    stream_boot_small(torch)
    long_k1, long_k2, _ = long_path(torch, card)
    torch.cuda.empty_cache()
    wide = wide_stream_path(torch, card, stream_peak)

    kernels = [
        dict(name='syrk', route='cuda', source='xmca_tpu_torch/csrc/syrk.cu',
             replaces='xmca_tpu/ops/syrk.py:95',
             launches=launches['syrk'], long=long_k1, wide=wide['k1'],
             **k1),
        dict(name='sign_field_sums', route='cuda',
             source='xmca_tpu_torch/csrc/sign_field.cu',
             replaces='xmca_tpu/ops/surrogate.py:403',
             launches=launches['sign_field_sums'], long=long_k2,
             wide=wide['k2'], **k2),
        dict(name='surrogate_gram', route='cuda',
             source='xmca_tpu_torch/csrc/surrogate_gram.cu',
             replaces='xmca_tpu/ops/surrogate.py:177',
             launches=gen_launches['surrogate_gram'], **k3),
        dict(name='surrogate_project', route='cuda',
             source='xmca_tpu_torch/csrc/surrogate_project.cu',
             replaces='xmca_tpu/ops/surrogate.py:259',
             launches=gen_launches['surrogate_project'], **k4),
        # on the public path of the generated 'normal16', 'normal32' and
        # 'rademacher' Rule-N (ensemble_path)
        dict(name='surrogate_field', route='cuda',
             source='xmca_tpu_torch/csrc/surrogate_field.cu',
             replaces='xmca_tpu/ops/surrogate.py:464',
             launches=sum(ens[d]['launches']['surrogate_field']
                          for d in ('normal16', 'normal32', 'rademacher')),
             **k5),
        # port-only: the JAX package's lax.scan has no Pallas counterpart;
        # on the public path of extend='theta' (extend_path)
        dict(name='ses_sweep', route='cuda',
             source='xmca_tpu_torch/csrc/ses_sweep.cu', replaces=None,
             launches=sum(ext_ses['theta'].values()),
             launches_by_stage=ext_ses['theta'], **k6),
        # port-only: the JAX package's convert is fused into its
        # contraction by XLA; on the public path of every rotated +-1
        # Rule-N run
        dict(name='pm1_project', route='cuda',
             source='xmca_tpu_torch/csrc/pm1_project.cu', replaces=None,
             launches=launches['pm1_project'], **k7),
    ]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--mesh-rank']:
        # one rank of mesh_path's four, started by mesh_path itself
        mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()

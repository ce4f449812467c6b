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
3. drives the main path once through the public API at full width: two
   synthetic (2000 steps x 250 x 400 cells) f32 fields through
   ``xMCA -> set_solver(truncate=10) -> normalize -> apply_coslat ->
   solve(complexify=True) -> rotate(10) -> rule_n(N_RUNS)``, with the
   kernels' launch counters reset just before and read just after;
4. runs the same path at a small size on the card and on the CPU (the
   plain versions, with the same random bits) and compares them;
5. drives the generated Rule-N surrogate
   (``core.fastpath.fast_surrogate_variance_gen``, fields generated
   inside the Gram and projection kernels, never stored) for N_GEN seeds
   at the same full width, with the counters reset just before and read
   just after, against ``fast_surrogate_variance_tri`` over the same
   seeds; then the same function small, on the card and on the CPU.

Any failure exits non-zero; nothing is caught.  The last lines are the
kernel table (JSON), the card's ``name, power.limit`` from nvidia-smi,
and the result line ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time

N_OBS, N_LAT, N_LON = 2000, 250, 400       # the bench.py workload
N_ROT = 10
N_RUNS = 64          # of the workload's 1000 surrogates: cut for time only
N_GEN = 32           # generated-surrogate runs: cut for time only
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


def _pm1_field(torch, n, p, n_pad, p_pad, gen, dtype):
    X = torch.zeros((n_pad, p_pad), dtype=dtype, device='cuda')
    bits = torch.randint(0, 2, (n, p), generator=gen, device='cuda')
    X[:n, :p] = (bits * 2 - 1).to(dtype)
    return X


# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet),
# for each kernel's bound: the larger of its operations over the peak of
# their type and its bytes (each input read once, each output written
# once) over the memory rate.
PEAK_OPS = {'int8': 1979e12, 'bf16': 989e12}
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

    # times at the main path's shape; the yardsticks compute the full
    # (not triangular) product in one library call, which the port never
    # makes
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
        err = float((kern() - syrk_reference(Xk)).abs().max())
        ms = _time_ms(torch, kern, 20)
        plain_ms = _time_ms(torch, lambda: syrk_reference(Xk), 5)
        library_ms = _time_ms(torch, lib, 20)
        b = _gram_bound(n_pad, p_pad, Xk.element_size(), name)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, **b)
        print('syrk {} at {}: kernel {:.4f} ms (PR 3: {:.4f} ms) = {:.1f}% '
              'of its bound {:.4f} ms ({}); plain {:.3f} ms; library {} '
              '{:.4f} ms (kernel / library {:.3f})'.format(
                  name, (n_pad, p_pad), ms, SYRK_PR3_MS[name],
                  100 * b['bound_ms'] / ms, b['bound_ms'], b['bound_by'],
                  plain_ms, lib_name, library_ms, ms / library_ms))
    return dict(out['int8'], bf16=out['bf16'])


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
    # chunk edges: p < C, p = C, p = 2C + 1 (a one-column last chunk), and
    # n = 130 (a padded second tile row)
    edges = [(n, 1000), (n, CHUNK_COLS), (n, 2 * CHUNK_COLS + 1),
             (130, 2 * CHUNK_COLS + 1)]
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


def project_registers():
    """Registers of each K4 kernel, from this process's -Xptxas -v log
    (empty when the library was not rebuilt here)."""
    import re
    from xmca_tpu_torch.ops import _build
    regs, fn = {}, None
    for line in _build.build_log().splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r'Used (\d+) registers', line)
        if m and fn and 'project_kernel' in fn:
            regs[fn] = int(m.group(1))
    return regs


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
    regs = project_registers()
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


def gen_runs(torch, fn, n_obs, n_vars, n_runs, device, **kw):
    """``n_runs`` Rule-N surrogate solves with the run seeds and start
    blocks of ``stats.significance``; returns (variances of the kept
    runs (numpy), totals, number kept, seconds per run)."""
    import numpy as np
    from xmca_tpu_torch.core.fastpath import hilbert_imag_matrix, start_block
    from xmca_tpu_torch.stats.significance import run_seeds
    H = torch.tensor(hilbert_imag_matrix(n_obs, np.float32), device=device)
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


def workload(torch, left, right, device, n_runs, n_rot, walls=None):
    """The main path; ``walls`` collects host seconds per stage (each
    stage ends in a device synchronize)."""
    from xmca_tpu_torch.xarray import xMCA

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if device == 'cuda':
            torch.cuda.synchronize()
        if walls is not None:
            walls[name] = time.perf_counter() - t0
        return out

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

    left, right = make_fields(N_OBS, N_LAT, N_LON)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    _build.reset_launch_counts()
    m, null = workload(torch, left, right, 'cuda', N_RUNS, N_ROT, walls)
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del left, right

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
    _check(launches.get('syrk', 0) == 2 * N_RUNS,
           'main path launched syrk {} times, not 2 x {}'.format(
               launches.get('syrk', 0), N_RUNS))
    _check(launches.get('sign_field_sums', 0) == 2 * N_RUNS,
           'main path launched sign_field_sums {} times, not 2 x {}'
           .format(launches.get('sign_field_sums', 0), N_RUNS))
    _check(null.shape[0] == N_ROT and null.shape[1] >= int(0.9 * N_RUNS),
           'Rule-N kept {} of {} runs'.format(null.shape[1], N_RUNS))
    _check(np.isfinite(null).all() and np.isfinite(var).all(),
           'non-finite results')

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

    gen_launches = gen_path(torch)
    gen_small(torch)

    kernels = [
        dict(name='syrk', route='cuda', source='xmca_tpu_torch/csrc/syrk.cu',
             replaces='xmca_tpu/ops/syrk.py:95',
             launches=launches['syrk'], **k1),
        dict(name='sign_field_sums', route='cuda',
             source='xmca_tpu_torch/csrc/sign_field.cu',
             replaces='xmca_tpu/ops/surrogate.py:403',
             launches=launches['sign_field_sums'], **k2),
        dict(name='surrogate_gram', route='cuda',
             source='xmca_tpu_torch/csrc/surrogate_gram.cu',
             replaces='xmca_tpu/ops/surrogate.py:177',
             launches=gen_launches['surrogate_gram'], **k3),
        dict(name='surrogate_project', route='cuda',
             source='xmca_tpu_torch/csrc/surrogate_project.cu',
             replaces='xmca_tpu/ops/surrogate.py:259',
             launches=gen_launches['surrogate_project'], **k4),
        # the oracle of the two above: no path stores the field
        dict(name='surrogate_field', route='cuda',
             source='xmca_tpu_torch/csrc/surrogate_field.cu',
             replaces='xmca_tpu/ops/surrogate.py:464',
             launches=gen_launches.get('surrogate_field', 0), **k5),
    ]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

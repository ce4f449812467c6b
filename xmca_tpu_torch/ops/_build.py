"""Build and load the port's CUDA kernels (``xmca_tpu_torch/csrc/*.cu``).

At first use every source is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into ONE
shared library with a plain C interface, which is loaded with
:mod:`ctypes`.  No PyTorch header is included, so the build takes
seconds.  The library lands in ``build/xmca_tpu_torch/`` beside the
package (the repository's ``build/`` directory, ignored by git) and is
rebuilt whenever a source or a shared header (``csrc/*.cuh``) is newer
than it.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.  There is no fallback: a kernel that does not build or does
not launch raises.

Wrappers count their launches in the ``launches`` counter of
:mod:`xmca_tpu_torch.utils.trace` (name -> count), one per kernel launch
and nowhere else, so a run can show which kernels its path went through;
:func:`launch_counts` reads it.
"""
import ctypes
import glob
import os
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), 'build',
                         'xmca_tpu_torch')
LIB_PATH = os.path.join(BUILD_DIR, 'libxmca_tpu_torch_kernels.so')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# dlopen/dlsym: csrc/syrk.cu takes cuTensorMapEncodeTiled from libcuda
LINK_FLAGS = ['-ldl']

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_D = ctypes.c_double
# C signature of every entry point: argtypes; restype int (a cudaError_t,
# or a size for xmca_syrk_smem_bytes)
_SIGNATURES = {
    'xmca_syrk': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    'xmca_syrk_smem_bytes': [],
    'xmca_sign_field_sums': [_P, _P, _I, _I, _I, _I, _U, _U, _P],
    'xmca_surrogate_field': [_P, _I, _I, _U, _I, _P],
    'xmca_surrogate_gram': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _U, _I, _P, _I, _P],
    'xmca_surrogate_project': [_P, _P, _I, _I, _I, _U, _I, _P],
    'xmca_ses_sweep': [_P, _I, _I, _I, _P, _I, _P, _P, _D, _D, _P, _P, _P,
                       _P, _P, _P],
    'xmca_pm1_project': [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
}

_state = {'lib': None, 'log': ''}


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu')))


def headers():
    return sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh')))


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA '
                           'toolkit that builds xmca_tpu_torch/csrc')
    return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def build():
    """Compile the kernels if the library is missing or stale; return
    the compiler's log (``-Xptxas -v``: registers, shared memory and
    spills per kernel), empty when nothing was rebuilt."""
    srcs = sources()
    if os.path.exists(LIB_PATH) and all(
            os.path.getmtime(s) <= os.path.getmtime(LIB_PATH)
            for s in srcs + headers()):
        return ''
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [os.path.join(BUILD_DIR, '{}.{}.o'.format(
        os.path.basename(src)[:-3], tag)) for src in srcs]
    jobs = []
    try:
        for src, obj in zip(srcs, objs):
            cmd = [nvcc] + NVCC_FLAGS + ['-c', '-o', obj, src]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in jobs]
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [(cmd, out) for cmd, out, rc in logs if rc != 0]
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(
            '{}\n{}'.format(' '.join(cmd), out) for cmd, out in failed))
    tmp = '{}.{}.tmp'.format(LIB_PATH, tag)
    cmd = [nvcc, '-shared', '-o', tmp] + objs + LINK_FLAGS
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError('nvcc link failed ({}):\n{}\n{}'.format(
            ' '.join(cmd), proc.stdout, proc.stderr))
    os.replace(tmp, LIB_PATH)          # atomic for concurrent builders
    return ''.join(out for _, out, _ in logs) + proc.stdout + proc.stderr


def library():
    """The loaded kernel library (built at first use)."""
    if _state['lib'] is None:
        _state['log'] = build()
        lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _state['lib'] = lib
    return _state['lib']


def build_log():
    """Compiler output of the build this process ran ('' if none)."""
    return _state['log']


def check(err, name):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        import torch
        raise RuntimeError('{} launch failed: CUDA error {} ({})'.format(
            name, err, torch.cuda.get_device_name()
            if torch.cuda.is_available() else 'no device'))


def stream_of(tensor):
    """Raw handle of PyTorch's current stream on ``tensor``'s device."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


def reset_launch_counts():
    from xmca_tpu_torch.utils import trace
    trace.reset_counters('launches')


def launch_counts():
    from xmca_tpu_torch.utils import trace
    return trace.counts('launches')

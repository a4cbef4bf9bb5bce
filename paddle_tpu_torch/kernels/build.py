"""Build the hand-written CUDA kernels and load them with ctypes.

Every `paddle_tpu_torch/csrc/*.cu` compiles with `nvcc` for `sm_90a` into
one shared library with a plain C interface.  The library lands in
`paddle_tpu_torch/_build/`, named by a hash of the sources and the flags,
so a changed source rebuilds and an unchanged one loads at once.  The
sources compile in parallel, one `nvcc` per file, and link once.  A
failing `nvcc` raises with its output.

`build_generated(sources)` is the second path: the CUDA C++ the kernel
generator (ops/kernelgen) wrote for a program's fused segments, in a few
translation units compiled in parallel (one `nvcc` each, the same ARCH
and FLAGS) and linked into one library under `_build/kernelgen/`, named
by a hash of the sources, the flags and the `csrc` digest.

    python -m paddle_tpu_torch.kernels.build     # build, print the log
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ['library', 'build', 'build_log', 'build_generated']

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
FLAGS = ['-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_lock = threading.Lock()
_lib = [None]
_log = ['']


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    cand = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found: the CUDA kernels of paddle_tpu_torch '
                       'are built from source on a machine with the CUDA '
                       'toolkit')


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, '*.cu')))
    if not srcs:
        raise RuntimeError('no CUDA sources under %s' % CSRC)
    return srcs


def _digest():
    h = hashlib.sha256(' '.join(ARCH + FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, '*'))):
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the sources if the hashed library is missing; return its
    path.  The compiler's output (registers, shared memory, spills from
    -Xptxas -v) is kept for `build_log()`."""
    lib_path = os.path.join(BUILD_DIR, 'libpt_kernels_%s.so' % _digest())
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    work = tempfile.mkdtemp(prefix='objs_', dir=BUILD_DIR)
    try:
        procs = []
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + '.o')
            cmd = [nvcc] + ARCH + FLAGS + ['-c', src, '-o', obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for src, obj, p in procs:
            out = p.communicate()[0].decode(errors='replace')
            logs.append('== %s\n%s' % (os.path.basename(src), out))
            if p.returncode != 0:
                failed.append(src)
        _log[0] = '\n'.join(logs)
        if failed:
            raise RuntimeError('nvcc failed on %s:\n%s'
                               % (', '.join(failed), _log[0]))
        tmp_lib = os.path.join(work, 'lib.so')
        cmd = [nvcc] + ARCH + ['-shared', '-o', tmp_lib] + \
            [obj for _, obj, _ in procs]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError('nvcc link failed:\n%s'
                               % link.stdout.decode(errors='replace'))
        os.replace(tmp_lib, lib_path)   # atomic: readers see all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def build_generated(sources):
    """Compile generated CUDA sources (one, or a list of whole
    translation units) into one shared library, cached by hash: one nvcc
    a source, all started together, then one link.  -> (library path,
    nvcc output, seconds spent compiling, 0.0 when the library was
    there)."""
    if isinstance(sources, str):
        sources = [sources]
    h = hashlib.sha256('\0'.join(sources).encode())
    h.update(_digest().encode())
    tag = h.hexdigest()[:16]
    out_dir = os.path.join(BUILD_DIR, 'kernelgen')
    lib_path = os.path.join(out_dir, 'libpt_kernelgen_%s.so' % tag)
    if os.path.exists(lib_path):
        return lib_path, '', 0.0
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix='kg_%s_' % tag, dir=out_dir)
    t0 = time.time()
    try:
        procs = []
        for k, source in enumerate(sources):
            # the sources stay beside the library, for reading
            src = os.path.join(out_dir, 'kernelgen_%s_%d.cu' % (tag, k))
            with open(src + '.tmp', 'w') as f:
                f.write(source)
            os.replace(src + '.tmp', src)
            obj = os.path.join(work, os.path.basename(src) + '.o')
            procs.append((src, obj, subprocess.Popen(
                [nvcc] + ARCH + FLAGS + ['-c', src, '-o', obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for src, obj, p in procs:
            logs.append(p.communicate()[0].decode(errors='replace'))
            if p.returncode != 0:
                failed.append(src)
        log = '\n'.join(logs)
        if failed:
            raise RuntimeError('nvcc failed on the generated kernels %s:\n%s'
                               % (', '.join(failed), log))
        tmp_lib = os.path.join(work, 'lib.so')
        res = subprocess.run([nvcc] + ARCH + ['-shared', '-o', tmp_lib] +
                             [obj for _, obj, _ in procs],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise RuntimeError('nvcc link of the generated kernels failed:\n%s'
                               % res.stdout.decode(errors='replace'))
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path, log, time.time() - t0


def build_log():
    """nvcc's output from this process's build ('' when it loaded a
    library built earlier)."""
    return _log[0]


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pt_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                 f, p]
    lib.pt_flash_fwd.restype = i
    lib.pt_flash_fwd_occupancy.argtypes = [i, i, p, p]
    lib.pt_flash_fwd_occupancy.restype = i
    lib.pt_embedding_gather.argtypes = [p, p, p, ctypes.c_longlong, i, i, i,
                                        i, p]
    lib.pt_embedding_gather.restype = i
    lib.pt_flash_bwd_dq.argtypes = [p] * 8 + [i] * 8 + [f, p]
    lib.pt_flash_bwd_dq.restype = i
    lib.pt_flash_bwd_dkv.argtypes = [p] * 9 + [i] * 8 + [f, p]
    lib.pt_flash_bwd_dkv.restype = i
    lib.pt_flash_cc_fwd.argtypes = lib.pt_flash_fwd.argtypes
    lib.pt_flash_cc_fwd.restype = i
    lib.pt_flash_cc_bwd_dq.argtypes = lib.pt_flash_bwd_dq.argtypes
    lib.pt_flash_cc_bwd_dq.restype = i
    lib.pt_flash_cc_bwd_dkv.argtypes = lib.pt_flash_bwd_dkv.argtypes
    lib.pt_flash_cc_bwd_dkv.restype = i
    lib.pt_flash_bwd_occupancy.argtypes = [i, i, i, p, p]
    lib.pt_flash_bwd_occupancy.restype = i
    lib.pt_flash_cc_occupancy.argtypes = [i, i, i, p, p]
    lib.pt_flash_cc_occupancy.restype = i
    lib.pt_layer_norm.argtypes = [p] * 6 + [ctypes.c_longlong, i, f, i, i,
                                            p]
    lib.pt_layer_norm.restype = i
    lib.pt_adam_multi.argtypes = [p, p, i, i, f, f, f, f, f, p]
    lib.pt_adam_multi.restype = i
    lib.pt_adam_multi_bf16.argtypes = [p, p, i, i, f, f, f, f, f, i, i, i,
                                       i, p]
    lib.pt_adam_multi_bf16.restype = i
    lib.pt_momentum_multi.argtypes = [p, p, i, i, f, i, p]
    lib.pt_momentum_multi.restype = i
    lib.pt_momentum_multi_bf16.argtypes = [p, p, i, i, f, f, i, i, p]
    lib.pt_momentum_multi_bf16.restype = i
    lib.pt_optim_multi.argtypes = [i, p, p, i, i, f, f, f, f, p]
    lib.pt_optim_multi.restype = i
    lib.pt_optim_multi_bf16.argtypes = [i, p, p, i, i] + [f] * 8 + [i, p]
    lib.pt_optim_multi_bf16.restype = i
    lib.pt_softmax.argtypes = [p, p, ctypes.c_longlong, i, i, p]
    lib.pt_softmax.restype = i
    lib.pt_error_string.argtypes = [i]
    lib.pt_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library, built at first use."""
    with _lock:
        if _lib[0] is None:
            _lib[0] = _bind(ctypes.CDLL(build()))
        return _lib[0]


if __name__ == '__main__':
    t0 = time.time()
    print(build())
    print(build_log())
    print('build_s=%.1f' % (time.time() - t0))

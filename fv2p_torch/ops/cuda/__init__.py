"""Hand-written Hopper kernels: build, bind and count launches.

Each kernel's source is ``ops/csrc/<name>.cu`` with a plain C interface.
At first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``build/kernels/`` at the repository root (named by a hash of source
and flags, so an edited source rebuilds) and loaded with ``ctypes``.

Every kernel module here pairs the launch with a plain PyTorch version of
the same function: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises. ``launch_counts`` reads one integer per
kernel, the ``launches.<kernel>`` counter of ``utils/tracing``, bumped only
where the kernel is launched.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections.abc import Mapping
from pathlib import Path

import torch

from ...utils import tracing

KERNELS = ('rotated_iou', 'fps', 'three_nn', 'sa_group')

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
# --fmad=false: distances and clip arithmetic round like the plain PyTorch
# versions (separate multiply and add); kernels that want fused
# multiply-adds ask for them with fmaf().
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--fmad=false', '-Xptxas=-v', '-shared', '-Xcompiler', '-fPIC')

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each library and their argument types (pointers, ints,
# the stream last); an entry point that launches returns cudaGetLastError()
# as an int, fv2p_three_nn_tile_rows a constant of the build.
_FPS_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _P)
SIGNATURES = {
    'rotated_iou': {'fv2p_overlap_matrix': (_P, _P, _P, _I, _I, _P),
                    'fv2p_iou_bev': (_P, _P, _P, _I, _I, _I, _P)},
    'fps': {'fv2p_fps': _FPS_ARGS, 'fv2p_fps_chain': _FPS_ARGS},
    'three_nn': {'fv2p_three_nn': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
                 'fv2p_three_nn_tile_rows': ()},
    'sa_group': {'fv2p_sa_group': (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _F, _F, _I, _I, _P)},
}

_libs = {}


class _LaunchCounts(Mapping):
    """{kernel: launches since the last reset}, a view of the tracing
    registry's ``launches.<kernel>`` counters."""

    def __getitem__(self, name):
        if name not in KERNELS:
            raise KeyError(name)
        return tracing.counter(f'launches.{name}')

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self):
        return len(KERNELS)


launch_counts = _LaunchCounts()


def reset_launch_counts():
    tracing.reset_counters('launches.')


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels are built with '
                           'the CUDA toolkit')
    return path


def library_path(name):
    src = (CSRC / f'{name}.cu').read_bytes()
    tag = hashlib.sha1(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}-{tag}.so'


def compile_sources(jobs):
    """jobs {label: (source path, library path)}: one nvcc process per
    source, all started together. Returns {label: (seconds, ptxas log)};
    raises with the compiler output on failure."""
    procs = {}
    t0 = time.perf_counter()
    for label, (src, out) in jobs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
    done = {}
    errors = []
    for label, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f'nvcc failed for {label}:\n{log}')
            continue
        os.replace(tmp, out)
        done[label] = (time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError('\n'.join(errors))
    return done


def build(names=KERNELS):
    """Compile the named kernels that are not built yet. Returns
    {name: (seconds, ptxas log)} for the ones compiled now."""
    return compile_sources({name: (CSRC / f'{name}.cu', library_path(name))
                            for name in names if not library_path(name).exists()})


def load(path, name):
    """The shared library at path as kernel `name`, its entry points typed."""
    lib = ctypes.CDLL(str(path))
    lib.fv2p_error_string.argtypes = [ctypes.c_int]
    lib.fv2p_error_string.restype = ctypes.c_char_p
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def library(name):
    """The loaded ctypes library of one kernel, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = load(library_path(name), name)
    return lib


def check_launch(name, lib, code):
    """Raise if the C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.fv2p_error_string(code).decode()
        raise RuntimeError(f'{name} kernel launch failed: {msg} ({code})')


def stream_handle(device):
    return torch.cuda.current_stream(device).cuda_stream


def require(cond, msg):
    if not cond:
        raise ValueError(msg)


def aligned(t, nbytes=16):
    """t itself, or a copy whose first element lies on an nbytes boundary
    (a view into a larger tensor may start anywhere)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def check_tensor(t, name, dtype, shape=None):
    """Validate what a kernel takes: CUDA device, dtype, contiguity, shape."""
    require(t.is_cuda, f'{name} must be a CUDA tensor')
    require(t.dtype == dtype, f'{name} must be {dtype}, got {t.dtype}')
    require(t.is_contiguous(), f'{name} must be contiguous')
    if shape is not None:
        require(tuple(t.shape) == tuple(shape),
                f'{name} must have shape {tuple(shape)}, got {tuple(t.shape)}')

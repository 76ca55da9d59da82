"""Host C++ libraries of the port: built by ``g++ -O3`` at first use into
``build/native/`` at the repository root (named by a hash of the source and
the flags, so an edited source rebuilds) and loaded with ``ctypes``.

A build writes to a temporary name and renames it into place, so processes
that build the same library at once (loader workers, test workers) never
load half a file. A failed build or load raises: there is no fallback."""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_libs = {}


def library_path(src):
    tag = hashlib.sha1(Path(src).read_bytes()
                       + ' '.join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'lib{Path(src).stem}-{tag}.so'


def build(src):
    """Compile src unless its library exists; returns the library's path."""
    out = library_path(src)
    if out.exists():
        return out
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError(f'g++ not found: {Path(src).name} is built with g++')
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    proc = subprocess.run([gxx, *GXX_FLAGS, str(src), '-o', str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed for {src}:\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    return out


def load(src, signatures):
    """The ctypes library of src, built at first use; ``signatures`` maps
    each entry point to (argtypes, restype)."""
    key = str(src)
    lib = _libs.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(src)))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _libs[key] = lib
    return lib

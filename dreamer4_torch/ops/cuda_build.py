"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
`sm_90a` into `dreamer4_torch/build/<name>-<hash>.so`, at first use, from the
sources in the checkout only. A hash of the source, of every local header it
includes (`#include "..."`, followed transitively), of the nvcc flags and of
the nvcc version names the library, so an edited source or header, other
flags or another compiler build anew and an unchanged build is loaded as it
is. `build_all` starts one nvcc per source at once. Nothing here runs when
the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


@functools.cache
def find_nvcc() -> str:
    for candidate in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if candidate:
            path = Path(candidate) / 'bin' / 'nvcc'
            if path.exists():
                return str(path)
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')
    return nvcc


@functools.cache
def nvcc_version() -> str:
    proc = subprocess.run([find_nvcc(), '--version'], capture_output=True, text=True,
                          check=True)
    return proc.stdout


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def kernel_names() -> list[str]:
    """Every kernel source of the package, by name (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC_DIR.glob('*.cu'))


def source_files(name: str) -> list[Path]:
    """`csrc/<name>.cu` and the local headers it includes, transitively, in
    the order they are first met."""
    files, todo = [], [CSRC_DIR / f'{name}.cu']
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode() + b'\0' + path.read_bytes())
    h.update('\0'.join(NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def build(name: str) -> tuple[Path, str]:
    """Compile `csrc/<name>.cu` unless its library exists. Returns the
    library path and what the compiler printed (register and shared-memory
    use per kernel; empty when the library was already built)."""
    out = library_path(name)
    if out.exists():
        return out, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private file, then rename: a concurrent build of the
    # same source never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp, str(CSRC_DIR / f'{name}.cu')]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def build_all() -> dict[str, tuple[Path, str]]:
    """Build every kernel source at once, one nvcc each. Returns what
    `build` returns, by name; raises on the first failure."""
    names = kernel_names()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib

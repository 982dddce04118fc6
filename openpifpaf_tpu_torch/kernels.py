"""Build and load the hand-written CUDA kernels (``csrc/<name>.cu``).

``cif_hr.cu`` (K1, the CifHr splat) and ``pair_chain.cu`` (K2, the pair
plan's stride-1 chain).  Each source compiles with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The library goes to
``build/openpifpaf_tpu_torch/`` beside the package, named by a hash of its
source, and is built at first use — never at import, so the package
imports on a machine without ``nvcc``.  ``build_all`` compiles several
sources at once, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / 'build' / 'openpifpaf_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIBS: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha1(src.read_bytes() + ' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}_{digest.hexdigest()[:12]}.so'


def build_all(names) -> Dict[str, str]:
    """Compile ``csrc/<name>.cu`` for each name not built yet, one ``nvcc``
    process each, all started together.  Returns nvcc's output per name
    (the ptxas register report; empty when nothing was built); raises on a
    failed build."""
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs, running = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = ''
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        running[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f'nvcc failed on {name}.cu (exit {proc.returncode}):'
                          f'\n{logs[name]}')
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return logs


def build(name: str) -> str:
    """``build_all`` of one source."""
    return build_all([name])[name]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]

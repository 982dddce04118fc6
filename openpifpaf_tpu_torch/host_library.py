"""Build the host's C++ libraries (``csrc/*.cpp``) at first use.

Each library has a plain C interface (no Python or PyTorch headers) and is
bound with ctypes.  It is built at first use, never at import, with the
host's C++ compiler (``$CXX``, else ``c++``) into
``build/openpifpaf_tpu_torch/`` beside the package, named by a hash of the
source, the compiler, the flags and the host's CPU (``-march=native``
code runs only where it was built).  Several processes (test workers, the
data loader's workers) may build at once: each writes a file of its own
and renames it into place.  A failed build raises with the compiler's
output; nothing falls back to another implementation.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

from .kernels import BUILD_DIR

CSRC = Path(__file__).resolve().parent / 'csrc'
CXX_FLAGS = ['-O3', '-march=native', '-fPIC', '-shared', '-std=c++17',
             '-Wall']


def compiler() -> str:
    return os.environ.get('CXX') or 'c++'


def host_cpu() -> bytes:
    """What ``-march=native`` reads: the CPU's model and flags."""
    try:
        with open('/proc/cpuinfo', 'rb') as f:
            lines = f.read().splitlines()
    except OSError:
        return b''
    return b'\n'.join(sorted({line for line in lines
                              if line.startswith((b'model name', b'flags'))}))


def library_path(source: Path, stem: str, flags: tuple = ()) -> Path:
    digest = hashlib.sha1(b'\0'.join([
        source.read_bytes(), compiler().encode(),
        ' '.join([*CXX_FLAGS, *flags]).encode(), host_cpu()]))
    return BUILD_DIR / f'lib{stem}_{digest.hexdigest()[:12]}.so'


def build(source: Path, stem: str, what: str, hint: str = '',
          flags: tuple = ()) -> Path:
    """Compile ``source`` with ``CXX_FLAGS`` and the library's own
    ``flags`` unless it is built; raises ``RuntimeError`` naming ``what``
    (and adding ``hint``) with the compiler's output when it fails."""
    out = library_path(source, stem, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    command = [compiler(), *CXX_FLAGS, *flags, '-o', str(tmp), str(source)]
    try:
        result = subprocess.run(command, capture_output=True, text=True,
                                timeout=300, check=False)
    except OSError as e:
        raise RuntimeError(f'{what}: cannot run {command[0]!r} ({e})'
                           f'{hint}') from e
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f'{what}: {" ".join(command)} failed (exit '
            f'{result.returncode}):\n{result.stdout}{result.stderr}')
    os.replace(tmp, out)
    return out

"""The build step the port's two compiled libraries share: the CUDA kernels
(``ops/_kernels.py``, nvcc) and the host runtime (``native``, g++).  Each
caller keeps its compiler, flags, sources and library name, and its own
lock, so one library's build never waits behind the other's."""

from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path
from typing import Callable

BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lotus_tpu_torch"


def build_library(build_dir: Path, stem: str, payload: bytes, compile_to: Callable[[Path], None]) -> Path:
    """The shared library ``build_dir / f"{stem}_{digest}.so"``, ``digest`` the
    first 12 hex digits of ``payload``'s SHA-1 (the sources and the flags),
    so an edit never loads a stale build.  Only when that file is missing,
    ``compile_to(out)`` builds ``out`` in a new temporary directory under
    ``build_dir`` (objects may go beside it), and the file moves into place
    by one atomic ``os.replace``: concurrent builders never load a partial
    file.  ``compile_to`` raises when its compiler fails."""
    path = build_dir / f"{stem}_{hashlib.sha1(payload).hexdigest()[:12]}.so"
    if path.exists():
        return path
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = Path(tmp) / "lib.so"
        compile_to(out)
        os.replace(out, path)
    return path

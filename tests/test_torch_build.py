"""``_build.build_library``, the build step the CUDA kernels (nvcc) and the
host runtime (g++) share, driven by a stand-in compiler: a Python command
that writes its output file, so the test needs neither nvcc nor g++."""

import hashlib
import subprocess
import sys

import pytest

from lotus_tpu_torch._build import build_library


def _fake_compiler(calls: list):
    def compile_to(out):
        calls.append(out)
        subprocess.run([sys.executable, "-c", "import sys; open(sys.argv[1], 'wb').write(b'lib')", str(out)],
                       check=True)
    return compile_to


def test_build_library_names_by_digest_and_reuses_the_file(tmp_path):
    calls = []
    build_dir = tmp_path / "build"
    path = build_library(build_dir, "libfake", b"source v1 -O3", _fake_compiler(calls))
    assert path == build_dir / f"libfake_{hashlib.sha1(b'source v1 -O3').hexdigest()[:12]}.so"
    assert path.read_bytes() == b"lib" and len(calls) == 1
    assert calls[0].parent.parent == build_dir and calls[0].parent != build_dir  # a temporary directory
    assert not calls[0].parent.exists()  # removed once the file moved into place
    assert build_library(build_dir, "libfake", b"source v1 -O3", _fake_compiler(calls)) == path
    assert len(calls) == 1  # the second call found the file: no rebuild
    edited = build_library(build_dir, "libfake", b"source v2 -O3", _fake_compiler(calls))
    assert edited != path and edited.exists() and len(calls) == 2  # an edit builds anew
    assert sorted(p.name for p in build_dir.iterdir()) == sorted([path.name, edited.name])


def test_build_library_failure_leaves_no_file(tmp_path):
    def broken(out):
        raise RuntimeError("compiler failed")

    with pytest.raises(RuntimeError, match="compiler failed"):
        build_library(tmp_path, "libfake", b"x", broken)
    assert list(tmp_path.iterdir()) == []

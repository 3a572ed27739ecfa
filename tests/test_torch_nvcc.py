"""Building the CUDA libraries (torchstore_tpu_torch.ops._nvcc) on the CPU, with a
stand-in ``nvcc`` that compiles a C++ source with the host compiler and
prints a ptxas-like report: a library built once is loaded from ``_build/``
by a later process, which reads the same compiler log (chip_smoke.py's
build phase gates every sm90 instance on it)."""

import ctypes
import os
import shutil
import stat

import pytest

from torchstore_tpu_torch.ops import _nvcc

REPORT = ("ptxas info    : Compiling entry function 'answer' for 'sm_90a'\n"
          "ptxas info    : Used 8 registers")

FAKE_NVCC = f"""#!/bin/sh
# Stand-in for nvcc: builds the last argument with g++ into the -o path.
out=""
prev=""
for arg in "$@"; do
  if [ "$prev" = "-o" ]; then out="$arg"; fi
  prev="$arg"
  src="$arg"
done
printf '%s\\n' "{REPORT}"
exec g++ -shared -fPIC -x c++ -o "$out" "$src"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "answer.cu"
    src.write_text('extern "C" int answer(int x) { return x + 1; }\n')
    return src


def test_cached_library_keeps_its_build_log(fake_nvcc):
    first = _nvcc.NvccLibrary(str(fake_nvcc), "answer", [ctypes.c_int])
    first.build()
    assert first.fn(41) == 42
    assert "Used 8 registers" in first.build_log
    built = sorted(p.suffix for p in _nvcc.BUILD_DIR.iterdir())
    assert built == [".log", ".so"]
    # A later process finds the library built: it compiles nothing and reads
    # the log written beside it.
    later = _nvcc.NvccLibrary(str(fake_nvcc), "answer", [ctypes.c_int])
    later.start()
    assert later._proc is None
    later.build()
    assert later.fn(1) == 2
    assert later.build_log == first.build_log


def test_failed_build_raises_and_leaves_nothing(fake_nvcc):
    fake_nvcc.write_text("this is not C++\n")
    lib = _nvcc.NvccLibrary(str(fake_nvcc), "answer", [ctypes.c_int])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lib.build()
    assert not any(p.suffix in (".so", ".log") for p in _nvcc.BUILD_DIR.iterdir())

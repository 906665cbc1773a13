"""The kernel build helper (`activegs_torch/render/_build.py`) on the CPU.

nvcc exists only where the card is, so a stand-in compiler, a shell script
that writes the library it is asked for and a ptxas-like line, takes its
place here.
"""

import stat

from activegs_torch.render import _build

FAKE_NVCC = """#!/bin/sh
# writes the file after -o, and names the source (the last argument)
while [ "$#" -gt 1 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "compiled $1" > "$out"
echo "ptxas info    : Used 40 registers ($1)"
"""


def test_build_all_builds_same_named_sources_of_two_directories(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    dirs = [tmp_path / "parent", tmp_path / "change"]
    for i, d in enumerate(dirs):
        d.mkdir()
        (d / "k.cu").write_text(f"// version {i}\n")
    libs = [_build.lib_path("k", d) for d in dirs]
    assert libs[0] != libs[1]

    logs = _build.build_all([(d, "k") for d in dirs])
    assert set(logs) == {"k"}
    for d, lib in zip(dirs, libs):
        assert lib.read_text() == f"compiled {d / 'k.cu'}\n"
        assert str(d / "k.cu") in lib.with_suffix(".log").read_text()
    assert not list((tmp_path / "kernels").glob("*.tmp"))
    # built libraries are reused
    assert _build.build_all([(d, "k") for d in dirs]) == {}


def test_source_digest_covers_a_kernel_and_the_headers_it_includes(tmp_path):
    """A library is named by its own source and the headers it includes:
    editing one kernel's source leaves another's library name alone, and
    editing a shared header renames both."""
    (tmp_path / "common.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// inner\n")
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "b.cu").write_text('  #  include "common.cuh"\n')
    (tmp_path / "c.cu").write_text("// no headers\n")
    assert [p.name for p in _build.sources("a", tmp_path)] == ["a.cu", "common.cuh", "inner.cuh"]
    before = {n: _build.source_digest(n, tmp_path) for n in "abc"}
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    after = {n: _build.source_digest(n, tmp_path) for n in "abc"}
    assert after["a"] != before["a"] and after["b"] == before["b"] and after["c"] == before["c"]
    (tmp_path / "inner.cuh").write_text("// inner, edited\n")
    last = {n: _build.source_digest(n, tmp_path) for n in "abc"}
    assert last["a"] != after["a"] and last["b"] != after["b"] and last["c"] == after["c"]
    assert _build.lib_path("b", tmp_path).name == f"b-{last['b']}.so"

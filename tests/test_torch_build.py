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

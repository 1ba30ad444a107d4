"""The kernel build driver (``ops/_build.py``) on the CPU, with a stand-in
for nvcc: every source of a library compiles, then one link; an unchanged
build is reused; a changed header or ``force`` rebuilds; a failed compile
raises with the compiler's output; ``build_sources`` links an arbitrary
set of sources (an earlier tree's, to time against)."""

import stat
import sys

import pytest

from edl_tpu_torch.ops import _build

# writes its -o target; "fails" on a source that holds "#error"
FAKE_NVCC = f"""#!{sys.executable}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
srcs = [a for a in args if a.endswith(".cu") or a.endswith(".o")]
for s in srcs:
    if s.endswith(".cu") and "#error" in open(s).read():
        print(s + ": error: stop")
        sys.exit(2)
open(out, "w").write(" ".join(srcs))
print("built " + out)
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "h.cuh"\n')
    (csrc / "b.cu").write_text("int b;\n")
    (csrc / "h.cuh").write_text("// header\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "LIBRARIES", {"k": ["a.cu", "b.cu"]})
    return csrc, tmp_path / "build"


def test_build_compiles_each_source_links_once_and_reuses(fake):
    csrc, out = fake
    log = _build.build()["k"]
    assert log.count("built ") == 3        # two compiles and the link
    lib = out / "libk.so"
    linked = lib.read_text().split()       # the fake link writes the objects it took
    assert len(linked) == 2 and all(o.endswith(".o") for o in linked)
    assert not list(out.glob("*.o"))       # objects are removed after the link
    assert _build.build() == {"k": ""}     # unchanged: reused
    (csrc / "h.cuh").write_text("// changed header\n")
    assert _build.build()["k"].count("built ") == 3
    assert _build.build(force=True)["k"].count("built ") == 3


def test_failed_compile_raises_with_the_output_and_keeps_the_old_library(fake):
    csrc, out = fake
    _build.build()
    before = (out / "libk.so").read_text()
    (csrc / "b.cu").write_text("#error broken\n")
    with pytest.raises(_build.KernelBuildError, match="b.cu: error: stop"):
        _build.build()
    assert (out / "libk.so").read_text() == before
    assert not list(out.glob("*.tmp*"))


def test_build_sources_links_any_set_of_sources(fake):
    csrc, out = fake
    lib = out / "libother.so"
    log = _build.build_sources([csrc / "b.cu"], lib)
    assert log.count("built ") == 2 and lib.exists()

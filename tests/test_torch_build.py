"""The CUDA kernels' build cache on the CPU (``kernels/_build.py``): the
path of a built library is keyed by its source, every ``csrc/*.cuh``
header the source includes (directly or through another header) and the
flags, so that an edited header is rebuilt rather than served stale from
the cache.  Nothing is compiled: no ``nvcc`` is needed."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

SOURCES = {
    "k.cu": '#include <cuda.h>\n#include "shared.cuh"\nint f() { return g(); }\n',
    "shared.cuh": '#pragma once\n  #  include "inner.cuh"\ninline int g() { return h(); }\n',
    "inner.cuh": "#pragma once\ninline int h() { return 1; }\n",
    "other.cuh": "#pragma once\ninline int u() { return 2; }\n",
}


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source tree of SOURCES under a temporary ``CSRC``."""
    for name, text in SOURCES.items():
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_sources_follow_the_includes(csrc):
    assert [p.name for p in _build._sources(csrc / "k.cu")] == [
        "k.cu", "shared.cuh", "inner.cuh"]


@pytest.mark.parametrize("edited,moves", [
    ("k.cu", True), ("shared.cuh", True), ("inner.cuh", True),
    ("other.cuh", False)])
def test_target_path_moves_with_each_included_header(csrc, edited, moves):
    """An edit to the source or to a header it includes (also through
    another header) gives another library path; an edit to a header it
    does not include, and undoing an edit, give the same one."""
    src, before = _build._target("k")
    assert src == csrc / "k.cu"
    assert before.parent == csrc / "_build" and before.name.startswith("k-")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert (_build._target("k")[1] != before) == moves
    path.write_text(SOURCES[edited])
    assert _build._target("k")[1] == before
    assert _build._target("k", ("X=1",))[1] != before


def test_package_sources_include_the_shared_header():
    """Both attention sources include ``hopper.cuh``, both scan sources
    ``tf32.cuh``; topo_score none."""
    for name, headers in (("flash_attention", ["hopper.cuh"]),
                          ("flash_attention_bwd", ["hopper.cuh"]),
                          ("topo_score", []), ("recurrent", ["tf32.cuh"]),
                          ("recurrent_bwd", ["tf32.cuh"])):
        found = _build._sources(_build.CSRC / f"{name}.cu")
        assert [p.name for p in found[1:]] == headers, name

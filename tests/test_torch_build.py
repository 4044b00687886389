"""The kernel build names each library by a digest of what it is built
from: its source, the shared headers in ``csrc`` and the compiler flags.
An edited header must give a new library path, or a stale library that
was built against the old header would be loaded.  A probe may route a
kernel's wrapper to another build of it for a block, and no longer."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "tiles.cuh").write_text("#pragma once\nconstexpr int kTile = 64;\n")
    (src / "kern.cu").write_text('#include "tiles.cuh"\n'
                                 'extern "C" int f() { return kTile; }\n')
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("edit", ["header", "new header", "source", "flags",
                                  "nothing"])
def test_library_path_follows_sources_headers_and_flags(csrc, monkeypatch,
                                                        edit):
    before = _build.library_path("kern")
    if edit == "header":
        (csrc / "tiles.cuh").write_text("#pragma once\n"
                                        "constexpr int kTile = 128;\n")
    elif edit == "new header":
        (csrc / "more.cuh").write_text("#pragma once\n")
    elif edit == "source":
        (csrc / "kern.cu").write_text('#include "tiles.cuh"\n'
                                      'extern "C" int f() { return 1; }\n')
    elif edit == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-G"))
    after = _build.library_path("kern")
    assert after.parent == _build.BUILD_DIR and after.name.startswith("libkern-")
    assert (after == before) == (edit == "nothing")


def test_headers_are_not_kernel_sources(csrc):
    assert _build.sources() == ["kern"]


def test_repo_headers_are_in_the_digest():
    """The attention kernels share ``csrc/bf16_mma.cuh``."""
    assert (_build.CSRC / "bf16_mma.cuh").exists()
    for name in ("flash_attention", "decode_attention"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "bf16_mma.cuh"' in text


@pytest.mark.parametrize("loaded", [False, True])
def test_library_swapped_routes_function_and_restores(monkeypatch, loaded):
    """A probe times another form of a kernel through its wrapper: inside
    the block ``function`` resolves in the other library; after it, even
    when the block raises, the loaded library (or none) is back."""
    from types import SimpleNamespace

    monkeypatch.setattr(_build, "_LIBS", {})
    mine = SimpleNamespace(f=SimpleNamespace())
    other = SimpleNamespace(f=SimpleNamespace())
    if loaded:
        _build._LIBS["kern"] = mine
    with pytest.raises(RuntimeError):
        with _build.library_swapped("kern", other):
            assert _build.function("kern", "f", [int]) is other.f
            assert other.f.argtypes == [int]
            raise RuntimeError("a failed check inside the block")
    assert _build._LIBS == ({"kern": mine} if loaded else {})

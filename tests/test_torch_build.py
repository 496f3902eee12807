"""The port's kernel build: a library's name hashes its CUDA source, the
csrc/ headers that source includes, and the compiler flags, so an edit to
a shared header rebuilds every kernel that includes it.  No compiler is
run: `library_path` only names the library."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ of one source including a header that includes another."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n'
                                   "int k;\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int other;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_an_edit_to_the_source_or_an_included_header_renames(csrc, edited):
    before = _build.library_path("k")
    (csrc / edited).write_text((csrc / edited).read_text() + "// edit\n")
    assert _build.library_path("k") != before


def test_an_edit_elsewhere_keeps_the_name(csrc):
    before = _build.library_path("k")
    (csrc / "other.cuh").write_text("int other2;\n")
    assert _build.library_path("k") == before


def test_the_attention_kernels_hash_their_shared_tile_core():
    for name in ("flash_attention", "ring_attention"):
        text = _build._source_text(name)
        assert b"attn_tile.cuh\0" in text and b"wgmma" in text

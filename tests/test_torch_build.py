"""The port's kernel build key (``repro_torch.kernels._build``): a
library is named by a hash of everything that builds it -- the source,
the ``csrc/*.cuh`` headers it includes (transitively) and the ``nvcc``
flags -- so no edit to any of them loads a stale build.  Nothing here
runs ``nvcc``."""

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "c.cuh").write_text("int c;\n")
    return tmp_path


def test_includes_are_followed_transitively(csrc):
    assert [p.name for p in _build.includes(csrc / "k.cu")] == ["a.cuh",
                                                               "b.cuh"]


@pytest.mark.parametrize("edit,changes", [
    ("k.cu", True), ("a.cuh", True), ("b.cuh", True), ("c.cuh", False)])
def test_library_path_follows_every_file_that_builds_it(csrc, edit,
                                                        changes):
    before = _build.library_path("k")
    with open(csrc / edit, "a") as f:
        f.write("// edited\n")
    assert (_build.library_path("k") != before) == changes
    assert _build.library_path("k").name.startswith("libk-")


def test_library_path_follows_the_flags(csrc, monkeypatch):
    before = _build.library_path("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("k") != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-1])
    assert _build.library_path("k") == before


def test_every_source_has_a_build_key():
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert "flash_attention" in names
    for name in names:
        assert _build.library_path(name).parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def _edit_renames_the_mixing_libraries(header, tmp_path, monkeypatch):
    """``header`` is included by the dense, the ELL and the quantized
    mixing sources, and an edit to it renames those three libraries (and
    not the flash kernel's), so no stale build of any is loaded."""
    mixing = ("mixing", "sparse_mixing", "quant_mixing")
    for name in mixing:
        assert _build.CSRC / header in _build.includes(
            _build.CSRC / f"{name}.cu")
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("mixing", "sparse_mixing", "quant_mixing", "flash_attention")
    before = {name: _build.library_path(name) for name in names}
    with open(tmp_path / header, "a") as f:
        f.write("// edited\n")
    after = {name: _build.library_path(name) for name in names}
    assert [name for name in names if after[name] != before[name]] == \
        list(mixing)


def test_the_staged_header_builds_all_three_mixing_sources(tmp_path,
                                                           monkeypatch):
    """``csrc/staged.cuh``: the TMA slab ring of the staged route."""
    _edit_renames_the_mixing_libraries("staged.cuh", tmp_path, monkeypatch)


def test_the_row_groups_header_builds_all_three_mixing_sources(tmp_path,
                                                               monkeypatch):
    """``csrc/row_groups.cuh``: the fixed-order sum of row groups the
    generic ELL kernels' aggregate legs use, and the aggregate GEMV."""
    _edit_renames_the_mixing_libraries("row_groups.cuh", tmp_path,
                                       monkeypatch)

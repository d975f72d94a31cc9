"""The port's kernel build (repro_torch/kernels/_build.py) on the CPU:
where a library goes and when it is rebuilt. Nothing is compiled here
(no nvcc); the build itself runs on the card through chip_smoke.py."""
from port_isolation import port_module_isolation  # noqa: F401
from repro_torch.kernels import _build


def _fake_kernel(tmp_path, monkeypatch):
    csrc = tmp_path / "k" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "helper.cuh"\n')
    (csrc / "helper.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    monkeypatch.setitem(_build.SOURCES, "k", "k/csrc/k.cu")
    return csrc


def test_library_path_follows_a_header_beside_the_source(tmp_path,
                                                         monkeypatch):
    """An edited header rebuilds: the library's name hashes every file of
    the kernel's csrc/, not only the .cu it compiles."""
    csrc = _fake_kernel(tmp_path, monkeypatch)
    first = _build.library_path("k")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")
    (csrc / "helper.cuh").write_text("// v2\n")
    assert _build.library_path("k") != first
    (csrc / "helper.cuh").write_text("// v1\n")
    assert _build.library_path("k") == first
    (csrc / "extra.cuh").write_text("// v1\n")          # a new header too
    assert _build.library_path("k") != first


def test_library_path_is_stable_and_distinct_per_kernel():
    paths = {name: _build.library_path(name) for name in _build.SOURCES}
    assert paths == {name: _build.library_path(name)
                     for name in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)

"""The kernel build (ops/_build.py) and the profile summary, on the CPU.

The sources compile only where nvcc is (the machine with the card); here
the tests hold what decides a build: one library per source named by its
hash, every source's entry points declared, and a clear error without nvcc.
"""

import pytest

from cuda_qr_tpu_torch.ops import _build
from cuda_qr_tpu_torch.utils.profile import _busy_us


def test_one_library_per_source_named_by_its_hash():
    paths = [_build.library_path(src) for src in _build._sources()]
    assert len(set(paths)) == len(paths) == len(_build._sources())
    for src, path in zip(_build._sources(), paths):
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"libcqt_{src.stem}_")
        assert _build.library_path(src) == path            # deterministic


def test_every_source_declares_its_entry_points():
    assert set(_build._SIGNATURES) == {src.name for src in _build._sources()}
    for src in _build._sources():
        text = src.read_text()
        for name in _build._SIGNATURES[src.name]:
            assert f'extern "C" int {name}(' in text


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("CUDA_PATH", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("intervals,busy", [([], 0.0), ([(0, 2), (1, 3)], 3.0),
                                            ([(5, 6), (0, 1), (0.5, 0.7)], 2.0),
                                            ([(0, 10), (2, 3)], 10.0)])
def test_busy_time_is_the_union_of_intervals(intervals, busy):
    assert _busy_us(intervals) == busy

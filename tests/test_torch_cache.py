"""``bayesgm_torch.utils.cache.enable_compilation_cache``: it points the
kernel builds (``ops/_build.py``) at a directory and creates it, takes
``$BAYESGM_TORCH_KERNEL_CACHE`` without an argument, is idempotent, and
refuses to switch once a kernel library has loaded."""

import pytest

pytest.importorskip("torch")

from bayesgm_torch.ops import _build  # noqa: E402
from bayesgm_torch.utils import cache  # noqa: E402


@pytest.fixture
def fresh_build_state(monkeypatch):
    """The module's process state as before any build, restored after."""
    monkeypatch.setattr(_build, "_BUILD_DIR", [])
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.delenv("BAYESGM_TORCH_KERNEL_CACHE", raising=False)


def test_default_is_the_checkouts_build_directory(fresh_build_state):
    assert _build.build_dir() == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "bayesgm_torch_kernels")


def test_sets_and_creates_the_directory(fresh_build_state, tmp_path):
    target = tmp_path / "kernels"
    assert cache.enable_compilation_cache(str(target)) is True
    assert target.is_dir() and _build.build_dir() == target.resolve()
    assert cache.enable_compilation_cache(str(target)) is True  # idempotent
    assert _build.build_dir() == target.resolve()


def test_environment_variable(fresh_build_state, tmp_path, monkeypatch):
    monkeypatch.setenv("BAYESGM_TORCH_KERNEL_CACHE", str(tmp_path / "env"))
    assert _build.build_dir() == tmp_path / "env"  # the first build takes it unasked
    monkeypatch.setattr(_build, "_BUILD_DIR", [])
    assert cache.enable_compilation_cache() is True
    assert (tmp_path / "env").is_dir() and _build.build_dir() == (tmp_path / "env").resolve()


def test_raises_after_a_kernel_has_loaded(fresh_build_state, tmp_path):
    cache.enable_compilation_cache(str(tmp_path / "a"))
    _build._LOADED["plain.cu"] = object()  # what load_library records after a load
    assert cache.enable_compilation_cache(str(tmp_path / "a")) is True
    with pytest.raises(RuntimeError, match="cannot switch"):
        cache.enable_compilation_cache(str(tmp_path / "b"))
    assert _build.build_dir() == (tmp_path / "a").resolve()

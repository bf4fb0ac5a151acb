"""Where the program runs: the compile cache's directory, device meshes
that never fall back to other devices, and the memory budget query."""

import os
import types

import jax
import pytest

from cudaparticlesfoam_tpu.parallel import auto, sharding
from cudaparticlesfoam_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_compile_cache_dir(monkeypatch, tmp_path, restore_cache_dir, env_set):
    """With JAX_COMPILATION_CACHE_DIR set the helper leaves JAX's own
    setting alone; unset, the cache goes to .jax_cache at the checkout
    root, a fixed path (no pid, time or temporary name in it)."""
    jax.config.update("jax_compilation_cache_dir", None)
    if env_set:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None
    else:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        path = compile_cache.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.enable_compile_cache() == path


def test_make_device_mesh_raises_when_too_few():
    have = len(jax.devices())
    assert sharding.make_device_mesh(have).devices.size == have
    with pytest.raises(ValueError, match=f"need {have + 1}"):
        sharding.make_device_mesh(have + 1)


def test_device_hbm_bytes_cpu_default():
    assert jax.default_backend() == "cpu"
    assert auto.device_hbm_bytes(default=123.0) == 123.0


@pytest.mark.parametrize("stats,expect", [
    ({"bytes_limit": 60e9}, 60e9),
    (None, RuntimeError),
])
def test_device_hbm_bytes_accelerator(monkeypatch, stats, expect):
    """An accelerator's reported limit is used; one that reports none is
    an error rather than a guessed default."""
    dev = types.SimpleNamespace(platform="gpu", device_kind="fake",
                                memory_stats=lambda: stats)
    monkeypatch.setattr(auto.jax, "devices", lambda *a: [dev])
    if expect is RuntimeError:
        with pytest.raises(RuntimeError, match="reports no memory limit"):
            auto.device_hbm_bytes()
    else:
        assert auto.device_hbm_bytes() == expect

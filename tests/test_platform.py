"""Platform policy: precision, compile cache and the native library build.

Nothing in the package picks a platform or a precision by itself:
`precision = double` enables x64 on the default device, the compile cache
follows JAX_COMPILATION_CACHE_DIR when it is set, and the native library
is rebuilt whenever its source is newer.
"""

import os

import jax
import pytest

from optimalcontrolmps import native, profiling
from optimalcontrolmps.config import InputGroup
from optimalcontrolmps.drivers.common import setup_precision


@pytest.fixture
def config_updates(monkeypatch):
    """Record every jax.config.update made by the code under test,
    without applying it."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


@pytest.mark.parametrize("precision, x64", [("double", True),
                                            ("single", False)])
def test_setup_precision_keeps_platform(config_updates, precision, x64):
    cfg = InputGroup("input", {"precision": precision})
    assert setup_precision(cfg) == precision
    names = [name for name, _ in config_updates]
    assert "jax_platforms" not in names
    assert (("jax_enable_x64", True) in config_updates) == x64


def test_compile_cache_honours_env(config_updates, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.enable_compile_cache() == str(tmp_path)
    assert config_updates == []


def test_compile_cache_default_is_checkout_dir(config_updates, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = profiling.enable_compile_cache()
    checkout = os.path.dirname(os.path.dirname(profiling.__file__))
    assert path == os.path.join(checkout, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in config_updates


def test_native_load_always_runs_make(monkeypatch):
    """A library built from an older source must never be loaded as it
    is: load() hands every first call to make, which rebuilds when the
    source is newer."""
    builds = []
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build", lambda: builds.append(1))
    lib = native.load()
    assert builds == [1]
    assert lib is None or os.path.exists(native._LIB_PATH)

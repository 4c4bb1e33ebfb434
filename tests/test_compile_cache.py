"""enable_compile_cache: a fixed directory in the checkout, unless the
environment names one."""
import os

import jax
import pytest

from pynama_tpu.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/cache"])
def test_cache_placement(monkeypatch, env_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    try:
        got = cc.enable_compile_cache()
        now = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_dir is None:
        assert got == os.path.join(REPO, ".jax_cache") == now
    else:
        assert got is None and now == before

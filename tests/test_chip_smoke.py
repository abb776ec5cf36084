"""chip_smoke.py and the compile-cache location, checked on the CPU.

Each case runs a fresh Python in a subprocess so that its environment
(JAX_PLATFORMS, JAX_COMPILATION_CACHE_DIR) is seen at import time.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra, env_drop=(), timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env.update(env_extra)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=timeout)


def test_chip_smoke_fails_without_gpu():
    out = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


_PRINT_CACHE = ("import jax, amcslam_tpu; "
                "print('CACHE', jax.config.jax_compilation_cache_dir)")


def test_compile_cache_follows_env(tmp_path):
    cache = str(tmp_path / "cache")
    out = _run(["-c", _PRINT_CACHE],
               {"JAX_PLATFORMS": "cpu", "JAX_COMPILATION_CACHE_DIR": cache},
               env_drop=("AMCSLAM_NO_COMPILE_CACHE",))
    assert out.returncode == 0, out.stderr
    assert f"CACHE {cache}" in out.stdout
    assert os.path.isdir(cache)


def test_compile_cache_defaults_to_checkout():
    out = _run(["-c", _PRINT_CACHE], {"JAX_PLATFORMS": "cpu"},
               env_drop=("JAX_COMPILATION_CACHE_DIR",
                         "AMCSLAM_NO_COMPILE_CACHE"))
    assert out.returncode == 0, out.stderr
    assert f"CACHE {os.path.join(REPO, '.jax_cache')}" in out.stdout

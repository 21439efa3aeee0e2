"""Which path the pipeline takes, where it keeps its compile cache, and how
the GPU smoke test refuses a machine without a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from minicom_tpu import native
from minicom_tpu.parallel import mesh
from minicom_tpu.parallel.store import ShardedReadStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_mesh():
    yield
    mesh.set_mesh(None)


@pytest.mark.parametrize("case,want", [
    ("cpu", False),            # CPU backend with the native twins loaded
    ("mesh", True),            # an active mesh always takes the device
    ("gpu", True),             # a GPU backend takes the device without one
    ("sharded_store", False),  # the row-sharded store keeps host kernels
])
def test_use_device_routes_by_platform(monkeypatch, case, want):
    if not native.has_native():
        pytest.skip("native toolchain unavailable")
    store = None
    if case == "mesh":
        mesh.set_mesh(mesh.make_mesh(1))
    elif case == "gpu":
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    elif case == "sharded_store":
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        mesh.set_mesh(mesh.make_mesh(1))
        store = ShardedReadStore(np.zeros((4, 8), np.uint8),
                                 np.array([0, 4]))
    assert mesh.use_device(store) is want


def _cache_dir(env_update: dict) -> str:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", "import jax, minicom_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) \
        == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout():
    first, second = _cache_dir({}), _cache_dir({})
    assert first == second == os.path.join(ROOT, ".jax_cache")


def test_chip_smoke_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs a GPU backend; JAX found cpu" in r.stderr
    assert '"ok"' not in r.stdout

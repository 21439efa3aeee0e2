"""Test env: CPU with 8 virtual devices, so sharding tests run anywhere.

Tests that need the card carry the ``gpu`` marker and the ``gpu`` fixture,
which skips them on any other backend. Selecting only them leaves JAX's
platform alone, so they reach the GPU:
    python -m pytest tests/test_gpu.py -m gpu -q
"""

import os

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU backend; run alone with -m gpu")
    if config.getoption("markexpr") == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        pytest.skip(f"needs a GPU backend (JAX found {backend})")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_reads(rng, n, L, p_n=0.0):
    """Random [n, L] ASCII read matrix with optional N probability."""
    codes = rng.integers(0, 4, size=(n, L))
    out = np.frombuffer(b"ACGT", dtype=np.uint8)[codes].copy()
    if p_n > 0:
        out[rng.random((n, L)) < p_n] = ord("N")
    return out


def genome_reads(rng, n, L, genome_len=10_000, err=0.01, p_n=0.0,
                 revcomp=True):
    """Reads sampled from a random genome with substitution errors — the
    workload shape the clustering pipeline is built for."""
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - L, size=n)
    reads = genome[starts[:, None] + np.arange(L)]
    # substitution errors
    em = rng.random((n, L)) < err
    reads = np.where(em, (reads + rng.integers(1, 4, size=(n, L))) % 4, reads)
    reads = reads.astype(np.uint8)
    if revcomp:
        flip = rng.random(n) < 0.5
        rc = np.flip(3 - reads[flip], axis=1)
        reads[flip] = rc
    out = np.frombuffer(b"ACGT", dtype=np.uint8)[reads].copy()
    if p_n > 0:
        out[rng.random((n, L)) < p_n] = ord("N")
    return out


def write_fastq(path, ascii_mat):
    with open(path, "wb") as f:
        for i, row in enumerate(ascii_mat):
            f.write(b"@r%d\n" % i)
            f.write(row.tobytes() + b"\n")
            f.write(b"+\n")
            f.write(b"I" * len(row) + b"\n")

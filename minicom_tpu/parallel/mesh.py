"""Device mesh + sharded encode step.

The reference's only parallel axis is a pthread pool over 2^14 lock-sharded
minimizer buckets (kthread_reads.c:208-218, SURVEY.md C22). The device
equivalent: a 1-D mesh axis `d` over the read batch for embarrassingly
parallel stages (classify/sketch) and over minimizer-hash space for the
grouping stages. `sharded_cluster_step` lets XLA insert the collectives for
the global sort (an all-to-all under the hood) by jitting the fused step with
batch-sharded inputs — the canonical, device-count-independent result comes
from the deterministic sort order, not from any locking.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from minicom_tpu.ops.step import cluster_step


# ---------------------------------------------------------------------------
# Device-time accounting: wall time the host spends blocked on the device
# (uploads + downloads + the async compute they drain), PLUS the bytes moved
# across the host<->device link. The bench reports
# device_seconds()/encode_wall as device_time_fraction and the byte total
# separately, because blocked wall alone does not separate transfer from
# device compute.
_DEVICE_SECONDS = 0.0
_DEVICE_BYTES = 0


def reset_device_seconds() -> None:
    global _DEVICE_SECONDS, _DEVICE_BYTES
    _DEVICE_SECONDS = 0.0
    _DEVICE_BYTES = 0


def device_seconds() -> float:
    return _DEVICE_SECONDS


def device_bytes() -> int:
    return _DEVICE_BYTES


def _account(dt: float, nbytes: int = 0) -> None:
    global _DEVICE_SECONDS, _DEVICE_BYTES
    _DEVICE_SECONDS += dt
    _DEVICE_BYTES += nbytes


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("d",))


# ---------------------------------------------------------------------------
# Active mesh for the host pipeline. When set, the pipeline's device batches
# (sketch, consensus) are placed row-sharded over axis `d`; XLA parallelizes
# the row-wise math and inserts collectives for the cross-row reductions.
# Archives stay byte-identical for ANY device count because all grouping /
# ordering decisions are deterministic host logic (tests/test_sharding.py).
_ACTIVE_MESH: Mesh | None = None


def set_mesh(mesh: Mesh | None) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def use_device(store=None) -> bool:
    """Whether the sketch and consensus stages run on the device.

    The one routing rule of the pipeline: the device path runs whenever a
    mesh is active or JAX's default backend is a GPU. On the CPU backend the
    native host twins (native/sketch.cpp, native/consensus.cpp) run instead,
    unless the native library failed to load. A row-sharded multi-process
    ``store`` (parallel/store.py) always keeps the host kernels: no rank holds
    the full matrix to upload. Both paths give byte-identical archives."""
    from minicom_tpu.parallel.store import ShardedReadStore
    if isinstance(store, ShardedReadStore):
        return False
    if _ACTIVE_MESH is not None or jax.default_backend() == "gpu":
        return True
    from minicom_tpu import native
    return not native.has_native()


def replicate(arr):
    """device_put an array replicated over the active mesh (no-op without
    one). Used for the device-resident read store, which every shard's
    gathers index freely."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return arr
    return jax.device_put(arr, NamedSharding(mesh, P()))


def upload_read_store(codes_sub: np.ndarray):
    """Upload the [N, L] read store replicated, with N padded to a pow2 tier
    so downstream XLA program shapes are dataset-size independent (each new
    (tier, L) pair compiles once per machine; padding rows are never
    gathered — rids stay < N)."""
    import time
    import jax.numpy as jnp
    n, L = codes_sub.shape
    n_pad = _store_tier(n)
    store = codes_sub
    if n_pad != n:
        store = np.zeros((n_pad, L), codes_sub.dtype)
        store[:n] = codes_sub
    t0 = time.perf_counter()
    out = replicate(jnp.asarray(store))
    out.block_until_ready()
    _account(time.perf_counter() - t0, store.nbytes)
    return out


def _store_tier(n: int) -> int:
    """Read-store row tier: pow2 plus the 1.5x midpoints (2^p and 3*2^(p-1)),
    floor 2^13 — max padding waste 33% instead of pow2's 100%, while the
    XLA program set per dataset stays at most two shapes larger."""
    n = max(n, 1)
    p = max(13, int(n - 1).bit_length())
    half = 3 << (p - 2)  # 1.5 * 2^(p-1)
    return half if n <= half else 1 << p


def shard_rows(arr):
    """device_put a [N, ...] batch row-sharded over the active mesh (no-op
    without one). N must divide by the mesh size — callers pad to pow2/fixed
    batch shapes which are multiples of any realistic device count."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return arr
    spec = P("d", *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def shard_last(arr):
    """device_put with the LAST axis sharded over the active mesh (no-op
    without one) — for packed uploads whose leading axes are chunk/field
    indices and whose trailing axis is the member batch."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return arr
    spec = P(*([None] * (arr.ndim - 1)), "d")
    return jax.device_put(arr, NamedSharding(mesh, spec))


def fetch(arrays):
    """Batched device->host transfer: start async copies for EVERY array,
    then materialize them, so the copies overlap instead of each waiting for
    the one before."""
    import time
    t0 = time.perf_counter()
    arrays = list(arrays)
    for a in arrays:
        if isinstance(a, jax.Array):
            a.copy_to_host_async()
    out = [np.asarray(a) for a in arrays]
    _account(time.perf_counter() - t0, sum(o.nbytes for o in out))
    return out


def sharded_cluster_step(mesh: Mesh, k: int, span_cols: int):
    """jit the fused cluster step with the read batch sharded over `d`.

    The minimizer sort is global: XLA lowers it to a distributed sort with
    an all-to-all exchange between devices; consensus scatter-adds land in
    a replicated column table (psum). Output sharding: consensus/coverage
    replicated, per-read vectors sharded like the input.
    """
    data = NamedSharding(mesh, P("d", None))
    repl = NamedSharding(mesh, P())
    vec = NamedSharding(mesh, P("d"))
    return jax.jit(
        lambda codes: cluster_step(codes, k, span_cols),
        in_shardings=data,
        out_shardings=(repl, repl, vec, vec, vec),
    )

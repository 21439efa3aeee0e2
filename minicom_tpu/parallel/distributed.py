"""Multi-process (multi-host) compression support.

The reference is strictly single-node: its only parallel axis is a pthread
pool over 2^14 lock-sharded minimizer buckets plus work stealing
(kthread_reads.c:208-218, kthread_cb.c:436-454 — SURVEY.md C22). This module
is the DCN/ICI-era equivalent: `jax.distributed` process groups where the
heavy stages split the SAME canonical work across processes and exchange
results with ordered all-gathers, so the archive is byte-identical for ANY
process count (tests/test_distributed.py) — where the reference bakes its
thread count into the format and its cluster composition into the schedule.

Sharding model (r04 — every heavy stage sharded; only input PARSING may
still replicate, and plain files byte-range-shard even that, io/fastq.py):
* the O(N*L) and O(N log N) stages are partitioned into CONTIGUOUS,
  canonically-ordered work ranges:
    - FASTQ parse: byte-range slices (plain files),
    - read sketching: contiguous slices of the pending pool,
    - cluster-round lexsort: hash-VALUE ranges (equal keys never straddle
      ranks, so rank-order concatenation IS the global sort),
    - segmented consensus: contiguous cluster ranges (disjoint column spaces,
      so no cross-process reduction is needed),
    - contig sketching: contiguous length-bucketed batch ranges,
    - merge candidate probes: contiguous probe ranges vs the small replicated
      index; overlap scoring: contiguous pair ranges,
    - realignment probes: contiguous contig ranges (the substring-key
      dictionaries are built replicated — the all-gathered-dictionary pattern),
    - serialization: member-sort sharded at cluster boundaries, diff text by
      member chunks; entropy coding by stream ranges (io/container.py),
* each exchange is an ordered ragged all-gather (rank-order concatenation
  reproduces the serial scan order exactly).
Remaining replicated host work: the cheap
orchestration glue — segment detection, matching, CSR bookkeeping — all
O(N) numpy passes with small constants.

Collectives move only 32-bit-or-smaller payloads (device code is strictly
32-bit — see ops/sketch.py); wider host dtypes travel as byte views.

Usage (one process per host):
    from minicom_tpu.parallel import distributed
    distributed.initialize("host0:9876", num_processes=4, process_id=rank)
    compressor.compress(...)   # stages auto-shard; rank 0's archive == all
"""

from __future__ import annotations

import numpy as np

_PID = 0
_NPROC = 1


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join the jax.distributed process group and enable stage sharding."""
    import jax
    jax.distributed.initialize(coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    set_process_grid(process_id, num_processes)


def set_process_grid(pid: int, nproc: int) -> None:
    global _PID, _NPROC
    assert 0 <= pid < nproc
    _PID, _NPROC = pid, nproc


def process_grid() -> tuple[int, int]:
    return _PID, _NPROC


def partition(weights: np.ndarray) -> list[tuple[int, int]]:
    """Split items into NPROC contiguous ranges of ~equal total weight.

    Deterministic: ranges depend only on the weights and the process count.
    Returns [(lo, hi)] per rank (some possibly empty).
    """
    n = len(weights)
    csum = np.cumsum(np.asarray(weights, np.float64))
    total = csum[-1] if n else 0.0
    bounds = [0]
    for p in range(1, _NPROC):
        bounds.append(int(np.searchsorted(csum, total * p / _NPROC)))
    bounds.append(n)
    for i in range(1, len(bounds)):  # enforce monotonicity on degenerate data
        bounds[i] = max(bounds[i], bounds[i - 1])
    return [(bounds[p], bounds[p + 1]) for p in range(_NPROC)]


def my_partition(weights: np.ndarray) -> tuple[int, int]:
    return partition(weights)[_PID]


def _pad_tier(n: int) -> int:
    """Collective payloads pad to a pow2 ladder (floor 4 KiB): the collective
    program is compiled per SHAPE with a cross-process agreement barrier, so
    a data-dependent pad length would compile (and barrier) on nearly every
    call — measured ~240 s of pure overhead on a 1M-read 2-process run. The
    ladder caps the program set at ~log2(payload) entries reused forever."""
    return 1 << max(12, int(max(n, 1) - 1).bit_length())


def allgather_ragged(arr: np.ndarray) -> np.ndarray:
    """Ordered all-gather of a 1-D array with per-process lengths; the result
    is the rank-order concatenation (identical on every process). No-op with
    a single process. Payload crosses the wire as uint8."""
    if _NPROC == 1:
        return arr
    return allgather_ragged_many([arr])[0]


def allgather_ragged_many(arrays: list[np.ndarray]) -> list[np.ndarray]:
    """Ordered all-gather of several 1-D arrays in ONE padded collective
    (plus one fixed-shape length exchange): stages that produce 4-5 ragged
    outputs per pass pay one barrier instead of 8-10."""
    if _NPROC == 1:
        return list(arrays)
    from jax.experimental import multihost_utils as mh
    views = [np.ascontiguousarray(a).view(np.uint8).reshape(-1)
             for a in arrays]
    dtypes = [np.asarray(a).dtype for a in arrays]
    k = len(views)
    # per-array lengths travel as two u32 words (lo, hi): device collectives
    # are 32-bit-only here, but a rank payload can exceed 2^31 bytes on large
    # inputs and must not silently wrap
    lens_local = np.array([len(v) for v in views], np.int64)
    l2 = np.empty((k, 2), np.uint32)
    l2[:, 0] = lens_local & 0xFFFFFFFF
    l2[:, 1] = lens_local >> 32
    gl = np.asarray(mh.process_allgather(l2.reshape(-1))).reshape(_NPROC, k, 2)
    lens = gl[:, :, 0].astype(np.int64) | (gl[:, :, 1].astype(np.int64) << 32)

    totals = lens.sum(axis=1)                      # payload bytes per rank
    pad = np.zeros(_pad_tier(int(totals.max())), np.uint8)
    pos = 0
    for v in views:
        pad[pos: pos + len(v)] = v
        pos += len(v)
    g = np.asarray(mh.process_allgather(pad))

    out = []
    starts = np.concatenate([np.zeros((_NPROC, 1), np.int64),
                             np.cumsum(lens, axis=1)], axis=1)
    for i in range(k):
        parts = [g[p, starts[p, i]: starts[p, i + 1]] for p in range(_NPROC)]
        out.append(np.concatenate(parts).view(dtypes[i]))
    return out

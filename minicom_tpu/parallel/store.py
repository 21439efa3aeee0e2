"""Row-sharded resident read store (VERDICT r04 missing #4).

The r04 pipeline all-gathered the full parsed [N, L] code matrix onto every
rank, so per-rank RSS was O(dataset) regardless of the process count.
Here each rank keeps ONLY its
contiguous row slice; the stages that need remote rows fetch them through
collective exchanges with bounded transient buffers:

* rows(rids)      — rank-SPECIFIC request lists (each rank asks for the rows
                    of its own work range; e.g. the serializer's member
                    chunks, consensus member gathers),
* rows_all(rids)  — IDENTICAL list on every rank (e.g. the realignment
                    singleton table, special-class streams): each rank
                    serves its owned rows once and everyone reassembles.

Both are collective: every rank must reach the same call site (the pipeline
stages already run lockstep — the same deterministic host logic computes the
same global decisions everywhere). Request rounds are chunked and the round
count is agreed up front, so ranks with short request lists keep
participating until the longest rank finishes.

Single-process runs never build this class — the pipeline uses the plain
ndarray (zero overhead, identical archives: sharding never changes bytes,
tests/test_distributed.py).
"""

from __future__ import annotations

import numpy as np

from minicom_tpu.parallel import distributed as dist


class ShardedReadStore:
    def __init__(self, local: np.ndarray, bounds: np.ndarray):
        pid, nproc = dist.process_grid()
        assert len(bounds) == nproc + 1
        self.local = local                     # [n_local, L] uint8 (owned)
        self.bounds = np.asarray(bounds, np.int64)
        self.r0 = int(self.bounds[pid])
        self.r1 = int(self.bounds[pid + 1])
        assert local.shape[0] == self.r1 - self.r0

    @property
    def shape(self) -> tuple[int, int]:
        return int(self.bounds[-1]), int(self.local.shape[1])

    @property
    def n(self) -> int:
        return int(self.bounds[-1])

    @property
    def L(self) -> int:
        return int(self.local.shape[1])

    # -- collective row access ------------------------------------------------

    def rows(self, rids: np.ndarray, chunk: int | None = None) -> np.ndarray:
        """Gather arbitrary global rows; COLLECTIVE — every rank passes its
        own request list (lengths may differ). Returns [len(rids), L]."""
        pid, nproc = dist.process_grid()
        rids = np.asarray(rids, np.int64)
        if nproc == 1:
            return self.local[rids]
        chunk = chunk or max(1 << 16, (1 << 19) // nproc)
        n_rounds = int(dist.allgather_ragged(
            np.array([-(-len(rids) // chunk)], np.int64)).max())
        out = np.empty((len(rids), self.L), np.uint8)
        for r in range(max(n_rounds, 1)):
            my_req = rids[r * chunk: (r + 1) * chunk]
            got = self._exchange(my_req, pid, nproc)
            out[r * chunk: r * chunk + len(my_req)] = got
            if n_rounds == 0:
                break
        return out

    def rows_all(self, rids: np.ndarray) -> np.ndarray:
        """Gather rows for an IDENTICAL request list on every rank: each rank
        serves its owned rows once (no duplicate request traffic). Returns
        [len(rids), L], identical everywhere."""
        pid, nproc = dist.process_grid()
        rids = np.asarray(rids, np.int64)
        if nproc == 1:
            return self.local[rids]
        owner = np.searchsorted(self.bounds[1:-1], rids, side="right")
        mine = rids[owner == pid]
        payload = self.local[mine - self.r0].reshape(-1)
        served = dist.allgather_ragged(payload).reshape(-1, self.L)
        # served rows are in (owner-rank, request-order) order
        inv = np.empty(len(rids), np.int64)
        inv[np.argsort(owner, kind="stable")] = np.arange(len(rids))
        return served[inv]

    def _exchange(self, my_req: np.ndarray, pid: int, nproc: int
                  ) -> np.ndarray:
        lens = dist.allgather_ragged(np.array([len(my_req)], np.int64))
        all_req = dist.allgather_ragged(my_req)
        owner = np.searchsorted(self.bounds[1:-1], all_req, side="right")
        payload = self.local[all_req[owner == pid] - self.r0].reshape(-1)
        served = dist.allgather_ragged(payload).reshape(-1, self.L)
        inv = np.empty(len(all_req), np.int64)
        inv[np.argsort(owner, kind="stable")] = np.arange(len(all_req))
        q0 = int(lens[:pid].sum())
        return served[inv[q0: q0 + len(my_req)]]


def maybe_shard(codes: np.ndarray):
    """Wrap a fully-parsed matrix into a ShardedReadStore (each rank KEEPS
    only its slice) on multi-process runs; pass-through otherwise. Used by
    the gzip/PE paths where the parse itself could not be byte-sharded."""
    _, nproc = dist.process_grid()
    if nproc == 1:
        return codes
    bounds = np.array([codes.shape[0] * p // nproc
                       for p in range(nproc + 1)], np.int64)
    pid, _ = dist.process_grid()
    local = np.ascontiguousarray(codes[bounds[pid]:bounds[pid + 1]])
    return ShardedReadStore(local, bounds)

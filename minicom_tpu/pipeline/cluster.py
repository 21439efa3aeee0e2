"""Cluster formation rounds (reference: kthread_bucket.c).

The reference shards minimizers into 2^14 lock-guarded buckets, radix-sorts
each bucket, splits equal-hash runs into clusters, and builds a consensus per
cluster with per-position count tables — ejecting reads whose mismatch count
exceeds ``e`` and re-bucketing them under a smaller k for the next round
(kthread_bucket.c:381-509, 562-629).

Here the bucket space disappears: ONE global sort by (hash, -aligned_pos, rid)
defines the clusters as segments of the sorted array, and consensus for every
cluster in a round is computed by a single segmented scatter-add
(`ops.consensus.segmented_consensus`). The k-decreasing rounds and their
stopping rules (new clustered reads < 100; k-round <= 9; round == R-1) are a
host loop, exactly mirroring kt_for_bucket's `last_rounds` state machine.

One deliberate fix vs the reference: aligned positions for reverse-strand
reads are mirrored with the ROUND's k (the reference reuses the initial k for
all rounds, kthread_bucket.c:52,93, which misaligns mixed-strand clusters in
later rounds).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from minicom_tpu.config import ResolvedConfig
from minicom_tpu.ops.consensus import (consensus_finalize,
                                       consensus_fused_rid_u,
                                       member_diffs_packed_rid_u, pack_parts,
                                       scatter_counts_rid_u)
from minicom_tpu.ops.pack import unpack_2bit_words
from minicom_tpu.ops.sketch import sketch_reads_dyn_gather_packed
from minicom_tpu.parallel import distributed as dist
from minicom_tpu.parallel import mesh
from minicom_tpu.parallel.mesh import fetch, shard_last, shard_rows


@dataclasses.dataclass
class ClusterSet:
    """CSR cluster store: members + consensus contigs, all flat numpy arrays.

    Member offsets are the column of the ORIENTED read's first base within the
    cluster's consensus (the reference's `pos_0 - pos`,
    kthread_bucket.c:99-101).
    """

    readlen: int
    mem_rid: np.ndarray       # [M] int64
    mem_off: np.ndarray       # [M] int32
    mem_dir: np.ndarray       # [M] int8
    cluster_ptr: np.ndarray   # [C+1] int64
    ref_flat: np.ndarray      # [R] uint8 consensus codes
    ref_ptr: np.ndarray       # [C+1] int64

    @property
    def n_clusters(self) -> int:
        return len(self.cluster_ptr) - 1

    @property
    def n_members(self) -> int:
        return len(self.mem_rid)

    def ref_lengths(self) -> np.ndarray:
        return np.diff(self.ref_ptr)

    def cluster_sizes(self) -> np.ndarray:
        return np.diff(self.cluster_ptr)

    @staticmethod
    def empty(readlen: int) -> "ClusterSet":
        z64 = np.zeros(0, np.int64)
        return ClusterSet(readlen, z64.copy(), np.zeros(0, np.int32),
                          np.zeros(0, np.int8), np.zeros(1, np.int64),
                          np.zeros(0, np.uint8), np.zeros(1, np.int64))

    @staticmethod
    def concat(sets: list["ClusterSet"]) -> "ClusterSet":
        sets = [s for s in sets if s.n_clusters > 0] or sets[:1]
        L = sets[0].readlen
        mem_rid = np.concatenate([s.mem_rid for s in sets])
        mem_off = np.concatenate([s.mem_off for s in sets])
        mem_dir = np.concatenate([s.mem_dir for s in sets])
        ptrs, rptrs, base, rbase = [np.zeros(1, np.int64)], [np.zeros(1, np.int64)], 0, 0
        for s in sets:
            ptrs.append(s.cluster_ptr[1:] + base)
            rptrs.append(s.ref_ptr[1:] + rbase)
            base += s.cluster_ptr[-1]
            rbase += s.ref_ptr[-1]
        ref_flat = np.concatenate([s.ref_flat for s in sets])
        return ClusterSet(L, mem_rid, mem_off, mem_dir,
                          np.concatenate(ptrs), ref_flat, np.concatenate(rptrs))


def _pow2(n: int) -> int:
    return 1 << max(4, int(n - 1).bit_length())


def _pow4(n: int) -> int:
    """Next power of 2 (with floor 2^14): column-table size buckets, so the
    set of XLA programs is small and data-independent (the persistent
    compile cache makes each size a one-time compile; pow2 granularity
    halves the worst-case padded compute vs pow4)."""
    p = 14
    while (1 << p) < n:
        p += 1
    return 1 << p


def consensus_from_members(readlen: int, seg_id: np.ndarray, offsets: np.ndarray,
                           rids: np.ndarray, dirs: np.ndarray,
                           n_segments: int, codes_dev,
                           want_ref: bool = True, want_diffs: bool = True,
                           codes_host: np.ndarray | None = None):
    """Batched consensus over CSR-grouped members (seg_id sorted ascending).

    Members are (rid, dir) references into the DEVICE-RESIDENT read store
    ``codes_dev`` ([N, L] uint8, uploaded once per pipeline) — gather and
    orientation happen on device, so only 13 bytes/member cross the
    host->device link per pass.

    Returns (ref_flat, ref_ptr, diffs[M]); consensus span of segment c =
    max(offset)+L (coverage is contiguous from column 0 because offsets
    include 0 — callers must pre-rebase offsets to min 0).

    Device work runs in FIXED batch shapes (member blocks of 2^13 / 2^17,
    column tables in power-of-4 buckets) accumulating into one donated count
    table, so every (shape) program is compiled at most once per machine.
    """
    L = readlen
    if len(seg_id) == 0:
        return np.zeros(0, np.uint8), np.zeros(n_segments + 1, np.int64), np.zeros(0, np.int32)
    seg_bounds = np.searchsorted(seg_id, np.arange(n_segments + 1))
    max_off = np.full(n_segments, -1, np.int64)
    np.maximum.at(max_off, seg_id, offsets)
    spans = np.where(np.diff(seg_bounds) > 0, max_off + L, 0)
    ref_ptr = np.zeros(n_segments + 1, np.int64)
    np.cumsum(spans, out=ref_ptr[1:])
    total = int(ref_ptr[-1])

    # multi-process: contiguous cluster ranges have DISJOINT column spaces,
    # so each rank builds its range's consensus independently and the chunks
    # are reassembled with an ordered all-gather — no cross-rank reduction
    seg_members = np.diff(seg_bounds)
    s0, s1 = dist.my_partition(seg_members)
    m0, m1 = int(seg_bounds[s0]), int(seg_bounds[s1])
    col0, col1 = int(ref_ptr[s0]), int(ref_ptr[s1])

    from minicom_tpu.parallel.store import ShardedReadStore
    if isinstance(codes_host, ShardedReadStore):
        # row-sharded store: gather just MY cluster range's member rows (a
        # collective exchange; every rank fetches its own disjoint range, so
        # per-rank transient is ~members/P rows) and count over the local
        # block with local indices
        from minicom_tpu import native
        rows = codes_host.rows(np.asarray(rids[m0:m1], np.int64))
        res = native.consensus_host(
            rows,
            (np.arange(m1 - m0, dtype=np.int64) * 2
             + dirs[m0:m1]).astype(np.int32),
            ref_ptr[seg_id[m0:m1]] - col0 + offsets[m0:m1],
            seg_bounds[s0:s1 + 1] - m0, ref_ptr[s0:s1 + 1] - col0,
            col1 - col0, want_ref, want_diffs)
        if res is None:
            raise RuntimeError(
                "sharded read store requires the native library")
        my_ref, my_diffs = res
        ref_flat = dist.allgather_ragged(my_ref) if want_ref else None
        diffs = dist.allgather_ragged(my_diffs) if want_diffs else None
        return ref_flat, ref_ptr, diffs

    if codes_host is not None and not mesh.use_device(codes_host):
        # host path: the native twin of the device kernels below
        # (consensus.cpp — identical argmax tie rule, identical bytes)
        from minicom_tpu import native
        my_ref, my_diffs = native.consensus_host(
            codes_host,
            (np.asarray(rids[m0:m1], np.int64) * 2
             + dirs[m0:m1]).astype(np.int32),
            ref_ptr[seg_id[m0:m1]] - col0 + offsets[m0:m1],
            seg_bounds[s0:s1 + 1] - m0, ref_ptr[s0:s1 + 1] - col0,
            col1 - col0, want_ref, want_diffs)
        ref_flat = dist.allgather_ragged(my_ref) if want_ref else None
        diffs = dist.allgather_ragged(my_diffs) if want_diffs else None
        return ref_flat, ref_ptr, diffs

    if codes_dev is None:  # caller did not pre-upload the read store
        codes_dev = mesh.upload_read_store(codes_host)

    my_ref, my_diffs = _consensus_chunk(
        L, base_all_lo=(ref_ptr[seg_id[m0:m1]] - col0).astype(np.int32),
        offsets=offsets[m0:m1], rids=rids[m0:m1], dirs=dirs[m0:m1],
        span=col1 - col0, codes_dev=codes_dev,
        want_ref=want_ref, want_diffs=want_diffs)
    ref_flat = dist.allgather_ragged(my_ref) if want_ref else None
    diffs = dist.allgather_ragged(my_diffs) if want_diffs else None
    return ref_flat, ref_ptr, diffs


def _consensus_chunk(L, base_all_lo, offsets, rids, dirs, span, codes_dev,
                     want_ref=True, want_diffs=True):
    """Consensus + member diffs for one contiguous column span (one rank's
    share). Fixed batch shapes; see consensus_from_members.

    The whole member set travels as ONE [n_chunks, 2, step] upload (rows:
    rid*2+dir, start column) and the outputs return as ONE packed uint32
    buffer; skipping an unwanted output (want_ref / want_diffs) skips its
    share of the transfer — the cluster rounds use only diffs on the
    ejection pass and only the consensus on the survivor pass."""
    M = len(base_all_lo)
    if M == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int32)
    Tp = _pow4(max(span, 1))
    small, big = 1 << 13, 1 << 17
    step = small if M <= small else big
    n_chunks = (M + step - 1) // step
    T = n_chunks * step
    rd_f = np.zeros(T, np.int32)  # rid*2 + dir (rid < 2^30: see load guard)
    rd_f[:M] = np.asarray(rids, np.int64) * 2 + dirs
    col_f = np.full(T, Tp, np.int32)  # padding members scatter out of range
    col_f[:M] = base_all_lo + offsets
    u = np.ascontiguousarray(
        np.stack([rd_f, col_f])
        .reshape(2, n_chunks, step).transpose(1, 0, 2))
    u_dev = shard_last(jnp.asarray(u))  # ONE upload

    if n_chunks == 1:  # one fused dispatch
        packed, diffs = consensus_fused_rid_u(codes_dev, u_dev[0], Tp)
        diff_parts = [diffs]
    else:
        table = jnp.zeros((Tp, 4), jnp.int32)
        for i in range(n_chunks):
            table = scatter_counts_rid_u(table, codes_dev, u_dev[i])
        packed = consensus_finalize(table)
        diff_parts = [member_diffs_packed_rid_u(packed, codes_dev, u_dev[i])
                      for i in range(n_chunks)] if want_diffs else []
    want = ([packed] if want_ref else []) + (diff_parts if want_diffs else [])
    buf = fetch([pack_parts(want)])[0]  # ONE download
    np_ref = Tp // 16
    off0 = np_ref if want_ref else 0
    ref_flat = unpack_2bit_words(buf[:np_ref], span) if want_ref else None
    diffs = None
    if want_diffs:
        diffs = buf[off0:off0 + n_chunks * (step // 2)].view(np.int16)
        diffs = diffs[:M].astype(np.int32)
    return ref_flat, diffs


def _sketch(pending: np.ndarray, codes_dev, k: int, L: int,
            codes_host: np.ndarray | None = None):
    """Whole-read minimizer + mirrored (oriented end) position, round-k aware.

    The grouping key is the exact canonical k-mer (uint64) — an identical
    partition to the reference's invertible hash64 grouping, with zero
    collision risk.

    Host path (mesh.use_device false): the sketch runs in the native host
    kernel (sketch.cpp, bit-identical outputs) and no read store is
    uploaded. Device path: reads are gathered on device from the resident
    store (4 bytes/read uploaded), batches have two fixed shapes, and k is
    traced (sketch_reads_dyn_gather) so ALL k-decreasing rounds share a
    handful of XLA compiles.
    """
    # row-sharded store: each rank sketches the pending reads IT OWNS (zero
    # remote row traffic), the results scatter back to pending order by the
    # exchanged pending-indices — identical output to the contiguous split
    from minicom_tpu.parallel.store import ShardedReadStore
    if isinstance(codes_host, ShardedReadStore):
        from minicom_tpu import native
        st = codes_host
        my_idx = np.flatnonzero((pending >= st.r0) & (pending < st.r1))
        res = native.sketch_reads_host(st.local, pending[my_idx] - st.r0, k)
        if res is None:
            raise RuntimeError(
                "sharded read store requires the native library")
        idx, khi, klo, pos, strand = dist.allgather_ragged_many(
            [my_idx, *res])
        out = [np.empty(len(pending), a.dtype)
               for a in (khi, klo, pos, strand)]
        for o, a in zip(out, (khi, klo, pos, strand)):
            o[idx] = a
        khi, klo, pos, strand = out
        key = (khi.astype(np.uint64) << np.uint64(32)) | klo.astype(np.uint64)
        mpos = np.where(strand == 1, L - pos + k - 2, pos).astype(np.int32)
        return key, mpos, strand.astype(np.int8)

    # multi-process: contiguous slice of the pool per rank, ordered gather
    lo, hi = dist.my_partition(np.ones(len(pending), np.int32))
    mine = pending[lo:hi]
    n = len(mine)

    host = None
    if codes_host is not None and not mesh.use_device(codes_host):
        from minicom_tpu import native
        host = native.sketch_reads_host(codes_host, mine, k)
    if host is not None:
        khi, klo, pos, strand = host
    else:
        if codes_dev is None:
            codes_dev = mesh.upload_read_store(codes_host)
        small, big = 1 << 13, 1 << 17  # two fixed batch shapes -> 2 compiles
        step = small if n <= small else big
        outs = []
        for s in range(0, n, step):
            t = min(s + step, n)
            rid = np.zeros(step, np.int32)
            rid[: t - s] = mine[s:t]
            outs.append(sketch_reads_dyn_gather_packed(
                codes_dev, shard_rows(jnp.asarray(rid)), k))
        # one packed [3, step] u32 array per batch (the h32 ranking hash
        # never leaves the device)
        packs = fetch(outs)
        parts = [(p[0, :min(s + step, n) - s], p[1, :min(s + step, n) - s],
                  (p[2, :min(s + step, n) - s] >> 1).astype(np.int32),
                  (p[2, :min(s + step, n) - s] & 1).astype(np.int8))
                 for s, p in zip(range(0, n, step), packs)]
        z32, z8 = np.zeros(0, np.uint32), np.zeros(0, np.int8)
        khi, klo, pos, strand = (
            np.concatenate([p[i] for p in parts]) if parts else z
            for i, z in ((0, z32), (1, z32), (2, z32.astype(np.int32)),
                         (3, z8)))
    khi, klo, pos, strand = dist.allgather_ragged_many(
        [khi, klo, pos, strand])
    key = (khi.astype(np.uint64) << np.uint64(32)) | klo.astype(np.uint64)
    mpos = np.where(strand == 1, L - pos + k - 2, pos).astype(np.int32)
    return key, mpos, strand.astype(np.int8)


def cluster_rounds(codes_sub: np.ndarray, pool: np.ndarray, cfg: ResolvedConfig,
                   codes_dev=None):
    """Run the k-decreasing clustering rounds.

    Returns (ClusterSet, sg) where sg is the singleton rid list in the
    deterministic order singles are produced (replaces the mutex-appended
    reads->sg, kthread_bucket.c:406-430).
    """
    L = codes_sub.shape[1]
    # the device path gathers every round's reads from ONE uploaded store
    if codes_dev is None and mesh.use_device(codes_sub):
        codes_dev = mesh.upload_read_store(codes_sub)
    K = cfg.k
    results: list[ClusterSet] = [ClusterSet.empty(L)]
    sg_parts: list[np.ndarray] = [np.zeros(0, np.int64)]

    pending = np.asarray(pool, np.int64)
    pre_cluster_reads = 0
    cluster_reads_total = 0
    last = 0
    rnd = 0
    k_round = K
    while len(pending) and k_round >= 4:
        rnd += 1
        if K - rnd <= 9:
            last += 1
        if rnd == cfg.max_rounds - 1:
            last += 1
        is_last = last > 0
        k_next = K - rnd  # ejected reads re-sketch with this k

        h, mpos, strand = _sketch(pending, codes_dev, k_round, L,
                                  codes_host=codes_sub)
        cs, singles, ejected, nreads = _one_round(
            codes_dev, codes_sub, pending, h, mpos, strand,
            cfg.diff_threshold, L)
        results.append(cs)
        sg_parts.append(singles)
        cluster_reads_total += nreads

        if is_last:
            sg_parts.append(ejected)
            pending = np.zeros(0, np.int64)
        else:
            pending = ejected
        k_round = k_next

        if last:
            last += 1
        if cluster_reads_total - pre_cluster_reads < 100:
            last += 1
        pre_cluster_reads = cluster_reads_total
        if last > 1:
            if len(pending):
                sg_parts.append(pending)
            break
    else:
        if len(pending):
            sg_parts.append(pending)

    return ClusterSet.concat(results), np.concatenate(sg_parts)


def _sharded_lexsort(h, mpos, rids):
    """np.lexsort((rids, -mpos, h)) with the sort itself sharded by hash-value
    range across processes (VERDICT r03 item 4: the round sort was fully
    replicated). Ranges are half-open intervals of the h VALUE (equal keys
    never straddle ranks), so the rank-order concatenation of per-range
    lexsorts IS the global lexsort. Splitters come from a deterministic
    sample, identical on every rank."""
    pid, nproc = dist.process_grid()
    neg = -mpos.astype(np.int64)
    if nproc == 1:
        return np.lexsort((rids, neg, h))
    sample = np.sort(h[::max(1, len(h) // 65536)])
    cuts = sample[(len(sample) * np.arange(1, nproc)) // nproc] \
        if len(sample) else np.zeros(0, h.dtype)
    lo = cuts[pid - 1] if pid else None
    hi = cuts[pid] if pid < nproc - 1 else None
    mask = np.ones(len(h), bool)
    if lo is not None:
        mask &= h >= lo
    if hi is not None:
        mask &= h < hi
    idx = np.flatnonzero(mask)
    mine = idx[np.lexsort((rids[idx], neg[idx], h[idx]))]
    return dist.allgather_ragged(mine)


def _one_round(codes_dev, codes_host, rids, h, mpos, strand, e, L):
    """One bucket round: sort -> segments -> consensus -> ejection.

    Returns (ClusterSet, singles, ejected, n_clustered_reads).
    """
    order = _sharded_lexsort(h, mpos, rids)
    h, mpos, strand, rids = h[order], mpos[order], strand[order], rids[order]
    new_seg = np.ones(len(h), bool)
    new_seg[1:] = h[1:] != h[:-1]
    seg_id = np.cumsum(new_seg) - 1
    n_seg = int(seg_id[-1]) + 1 if len(h) else 0
    seg_start = np.flatnonzero(new_seg)
    seg_sizes = np.diff(np.append(seg_start, len(h)))

    multi = seg_sizes >= 2
    singles = rids[np.isin(seg_id, np.flatnonzero(~multi))]
    keep = multi[seg_id]
    if not keep.any():
        return ClusterSet.empty(L), np.sort(singles), np.zeros(0, np.int64), 0

    h2, mpos2, strand2, rids2 = h[keep], mpos[keep], strand[keep], rids[keep]
    seg2 = (np.cumsum(np.r_[True, h2[1:] != h2[:-1]]) - 1).astype(np.int64)
    n2 = int(seg2[-1]) + 1

    # alignment offsets: first (max) mpos of each segment anchors column 0
    first_idx = np.r_[0, 1 + np.flatnonzero(seg2[1:] != seg2[:-1])]
    off = (mpos2[first_idx][seg2] - mpos2).astype(np.int32)

    _ref, _rptr, diffs = consensus_from_members(
        L, seg2, off, rids2, strand2, n2, codes_dev, want_ref=False,
        codes_host=codes_host)

    surv = diffs <= e
    ejected = rids2[~surv]

    # survivor recount; clusters keep >= 2 members
    surv_per = np.bincount(seg2[surv], minlength=n2)
    good = surv_per >= 2
    lonely = surv & ~good[seg2]          # single survivor -> back to pool
    ejected = np.concatenate([ejected, rids2[lonely]])
    final = surv & good[seg2]
    if not final.any():
        return ClusterSet.empty(L), np.sort(singles), np.sort(ejected), 0

    segF = seg2[final]
    remap = np.cumsum(good) - 1
    segF = remap[segF]
    nF = int(segF[-1]) + 1
    offF = off[final]
    # rebase offsets so each cluster starts at column 0 (reference trims
    # leading zero-coverage columns, kthread_bucket.c:304-350)
    min_off = np.full(nF, np.iinfo(np.int32).max, np.int64)
    np.minimum.at(min_off, segF, offF)
    offF = (offF - min_off[segF]).astype(np.int32)

    refF, rptrF, _ = consensus_from_members(
        L, segF, offF, rids2[final], strand2[final], nF, codes_dev,
        want_diffs=False, codes_host=codes_host)
    cptr = np.zeros(nF + 1, np.int64)
    np.cumsum(np.bincount(segF, minlength=nF), out=cptr[1:])
    cs = ClusterSet(L, rids2[final], offF, strand2[final], cptr, refF, rptrF)
    return cs, np.sort(singles), np.sort(ejected), int(final.sum())

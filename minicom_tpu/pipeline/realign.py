"""Singleton realignment ladder (reference: kthread_hash_realign.c +
bbhashdict.c).

The reference packs every leftover singleton into std::bitset<2*readlen>,
builds `numdict_s` BooPHF minimal-perfect-hash dictionaries over contiguous
substring windows, slides every contig offset probing each dictionary forward
and reverse-complement, verifies candidates by bitset-XOR popcount <=
threshold plus an encode-cost check, and claims reads under lock-striped
trylocks with lazy dictionary deletion — a schedule-dependent, best-effort
search (kthread_hash_realign.c:375-377,425-433).

Deterministic data-parallel rebuild:
* the MPHF becomes a SORTED-KEY GATHER TABLE per dictionary: keys are the
  2-bit-packed substring windows of all singletons, sorted; lookup is a
  vectorized binary search + CSR slice (SURVEY.md §7 step 7),
* every (contig, offset) window probes all dictionaries fwd + rc in one
  vectorized pass per threshold rung,
* verification = XOR-popcount over packed 2-bit words (basediff,
  bbhashdict.c:247-254) capped by the threshold, plus the exact
  encode-cost <= 0.4*readlen rule (encode_byte, :283-314; on the rc path the
  cost check only applies when threshold > 24, :461 — quirk preserved),
* claiming is conflict-free: every read takes its best candidate
  (min (popcount, contig, offset, dir)) via one sort — no locks, canonical
  result,
* the threshold ladder e, e+S, ..., <= E with the < 1000-new-reads stopping
  rule mirrors preprocess.c:197-232, and each rung first absorbs near-allA /
  near-allT singles into the AA/TT streams (singleRead2bitset,
  bbhashdict.c:127-227).
"""

from __future__ import annotations

import numpy as np

from minicom_tpu.config import ResolvedConfig
from minicom_tpu.native import diff_encode_lengths
from minicom_tpu.ops.pack import (codes_to_ascii, pack_2bit_words,
                                  popcount_u32, revcomp_codes)
from minicom_tpu.pipeline.cluster import ClusterSet


def _pack_key(codes: np.ndarray, start: int, seg_len: int) -> np.ndarray:
    """[N, L] codes -> uint64 keys of the [start, start+seg_len) window."""
    w = codes[:, start:start + seg_len].astype(np.uint64)
    key = np.zeros(len(codes), np.uint64)
    for i in range(seg_len):
        key |= w[:, i] << np.uint64(2 * i)
    return key


class SortedKeyDict:
    """Sorted-key gather table: the data-parallel replacement for BooPHF+CSR
    (bbhashdict.h:21-43). Lookup = binary search into the sorted key array;
    hits slice a CSR range of singleton indices."""

    def __init__(self, keys: np.ndarray):
        self.order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[self.order]

    def lookup(self, queries: np.ndarray, max_hits: int):
        """Returns (starts, counts) into self.order for each query (count
        capped at max_hits, newest-first semantics irrelevant — static)."""
        lo = np.searchsorted(self.sorted_keys, queries, side="left")
        hi = np.searchsorted(self.sorted_keys, queries, side="right")
        return lo, np.minimum(hi - lo, max_hits)


def _window_keys(ref_flat, win_starts, seg_start, seg_len):
    """Keys of ref windows at (flat) start positions, dict segment offset."""
    idx = win_starts[:, None] + (seg_start + np.arange(seg_len))[None, :]
    w = ref_flat[idx].astype(np.uint64)
    key = np.zeros(len(win_starts), np.uint64)
    for i in range(seg_len):
        key |= w[:, i] << np.uint64(2 * i)
    return key


def realign_ladder(cset: ClusterSet, sg: np.ndarray, codes_sub: np.ndarray,
                   n_mask: np.ndarray, cfg: ResolvedConfig,
                   stats: dict | None = None):
    """Returns (cset', sg_leftover, absorbed_nearA, absorbed_nearT)."""
    from minicom_tpu.pipeline.merge import _sub
    L = cset.readlen
    extra_a: list[np.ndarray] = [np.zeros(0, np.int64)]
    extra_t: list[np.ndarray] = [np.zeros(0, np.int64)]
    if cset.n_clusters == 0 or len(sg) == 0:
        return cset, sg, extra_a[0], extra_t[0]

    ranges = cfg.dict_ranges()
    new_members = []            # (rid, cluster, off, dir) tuples as arrays
    pre_claimed_total = 0
    claimed_total = 0
    big_input = len(sg) > 1_000_000 and L >= 68

    # row-sharded store: materialize the singleton rows ONCE (identical on
    # every rank — the replicated-dictionary pattern, SURVEY §5; the rows
    # subset in lockstep with sg as rungs claim reads). The per-rank cost is
    # O(n_sg * L), a shrinking fraction of the dataset; the FULL store stays
    # sharded (VERDICT r04 missing #4).
    from minicom_tpu.parallel.store import ShardedReadStore
    if isinstance(codes_sub, ShardedReadStore):
        sgc_all = codes_sub.rows_all(sg)
    else:
        sgc_all = None

    thr = cfg.diff_threshold
    pop_a = pop_t = None    # per-read base-diff counts vs all-A / all-T:
    prev_thr = -1           # rung-invariant — computed once, subset as sg
    while thr <= cfg.max_threshold and len(sg):   # shrinks (r04 absorb diet)
        # --- near-allA/allT absorption at this threshold ------------------
        with _sub(stats, "realign_absorb"):
            if pop_a is None:
                from minicom_tpu import native
                if sgc_all is not None:
                    pops = native.popcounts_at(
                        sgc_all, np.arange(len(sg), dtype=np.int64))
                else:
                    pops = native.popcounts_at(codes_sub, sg)
                if pops is not None:
                    pop_a, pop_t = pops
                else:
                    sgc0 = (sgc_all if sgc_all is not None
                            else codes_sub[sg])
                    pop_a = popcount_u32(pack_2bit_words(sgc0)).sum(axis=1)
                    pop_t = popcount_u32(pack_2bit_words(3 - sgc0)).sum(axis=1)
                    del sgc0
            cand_a = pop_a <= thr
            cand_t = ~cand_a & (pop_t <= thr)
            # the encode-cost check is also rung-invariant, so only reads
            # whose popcount FIRST clears the (growing) threshold at this
            # rung need it — earlier-rung failures stay failures
            new_a = cand_a & (pop_a > prev_thr)
            new_t = cand_t & (pop_t > prev_thr)
            absorbed = np.zeros(len(sg), bool)
            for mask, const, bucket in ((new_a, b"A", extra_a),
                                        (new_t, b"T", extra_t)):
                rows = np.flatnonzero(mask)
                if len(rows) == 0:
                    continue
                restored = (sgc_all[rows] if sgc_all is not None
                            else codes_sub[sg[rows]]).copy()
                restored[n_mask[sg[rows]]] = 4
                lens = diff_encode_lengths(
                    np.full((len(rows), L), const[0], np.uint8),
                    codes_to_ascii(restored), 1)
                take = rows[lens <= 0.4 * L]
                if len(take):
                    bucket.append(sg[take])
                    absorbed[take] = True
            prev_thr = thr
            if absorbed.any():
                keep = ~absorbed
                sg, pop_a, pop_t = sg[keep], pop_a[keep], pop_t[keep]
                if sgc_all is not None:
                    sgc_all = sgc_all[keep]
        if len(sg) == 0:
            break

        # --- probe every (contig, offset) window fwd + rc -----------------
        # multi-process: contiguous contig range per rank, ordered gather of
        # the candidate arrays (rank order == the serial contig scan order);
        # the substring-key dictionaries are built replicated on every rank
        # (the all-gathered-dictionary pattern, SURVEY.md §5)
        from minicom_tpu import native
        from minicom_tpu.parallel import distributed as dist
        sgc = sgc_all if sgc_all is not None else codes_sub[sg]
        with _sub(stats, "realign_probe"):
            probe = _probe_native_sharded(dist, native, cset, sgc, ranges,
                                          cfg, thr)
        if probe is not None:
            cand_sg, cand_cl, cand_off, cand_dir, cand_pop = (
                x.astype(np.int64) if x.dtype != np.int8 else x
                for x in probe)
            # the native probe already reduced to the best placement per
            # read under the claim order (realign.cpp r05); the lexsort
            # below is then tiny — and on multi-rank runs it picks the
            # global winner among the per-rank (disjoint contig range)
            # winners, which equals the winner over the full candidate set
        else:  # pure-Python environment: vectorized numpy reference path
            sg_words = pack_2bit_words(sgc)             # [S, W]
            dicts = [SortedKeyDict(_pack_key(sgc, s, e - s + 1))
                     for (s, e) in ranges]
            ref_lens = cset.ref_lengths()
            n_off = np.maximum(ref_lens - L + 1, 0)
            tot_w = int(n_off.sum())
            if tot_w == 0:
                break
            wseg = np.repeat(np.arange(cset.n_clusters), n_off)
            woff = (np.arange(tot_w)
                    - np.repeat(np.cumsum(np.r_[0, n_off[:-1]]), n_off))
            wflat = cset.ref_ptr[wseg] + woff           # flat window starts
            cand_sg, cand_cl, cand_off, cand_dir, cand_pop = \
                _probe_and_verify(cset, wflat, wseg, woff, dicts, ranges,
                                  sg_words, L, thr, cfg.max_search)
            if len(cand_sg):
                ok = _encode_cost_ok(cset, sgc, cand_sg, cand_cl,
                                     cand_off, cand_dir, thr, L)
                cand_sg, cand_cl, cand_off, cand_dir, cand_pop = (
                    x[ok] for x in (cand_sg, cand_cl, cand_off, cand_dir,
                                    cand_pop))

        # --- best candidate per read (deterministic claim) ----------------
        if len(cand_sg):
            with _sub(stats, "realign_claim"):
                order = np.lexsort((cand_dir, cand_off, cand_cl, cand_pop,
                                    cand_sg))
                first = np.ones(len(order), bool)
                ss = cand_sg[order]
                first[1:] = ss[1:] != ss[:-1]
                pick = order[first]
                new_members.append((sg[cand_sg[pick]], cand_cl[pick],
                                   cand_off[pick], cand_dir[pick]))
                claimed = np.zeros(len(sg), bool)
                claimed[cand_sg[pick]] = True
                claimed_total += int(claimed.sum())
                keep = ~claimed
                sg, pop_a, pop_t = sg[keep], pop_a[keep], pop_t[keep]
                if sgc_all is not None:
                    sgc_all = sgc_all[keep]

        # stopping rule (preprocess.c:219-228)
        max_new = 10_000 if big_input else 1_000
        if claimed_total - pre_claimed_total < max_new:
            break
        pre_claimed_total = claimed_total
        thr += cfg.thr_step

    if new_members:
        cset = _append_members(cset, new_members)
    ea = np.concatenate(extra_a) if len(extra_a) > 1 else extra_a[0]
    et = np.concatenate(extra_t) if len(extra_t) > 1 else extra_t[0]
    return cset, sg, ea, et


def _probe_native_sharded(dist, native, cset, sgc, ranges, cfg, thr):
    """Native probe over this rank's contiguous contig range; candidates are
    all-gathered in rank order, reproducing the serial scan order exactly.
    Returns None when the native library is unavailable (numpy fallback runs
    unsharded but identically on every rank)."""
    L = cset.readlen
    n_off = np.maximum(cset.ref_lengths() - L + 1, 0)
    c0, c1 = dist.my_partition(n_off)
    ref_ptr_loc = (cset.ref_ptr[c0:c1 + 1] - cset.ref_ptr[c0]).astype(np.int64)
    ref_flat_loc = cset.ref_flat[cset.ref_ptr[c0]:cset.ref_ptr[c1]]
    probe = native.realign_probe(
        ref_flat_loc, ref_ptr_loc, sgc,
        np.array([s for s, _ in ranges], np.int32),
        cfg.dict_seg_len, thr, cfg.max_search, rc_skip_cost=thr <= 24)
    if probe is None:
        return None
    cand_sg, cand_cl, cand_off, cand_dir, cand_pop = probe
    cand_cl = cand_cl + np.int32(c0)
    _, nproc = dist.process_grid()
    if nproc > 1:
        cand_sg, cand_cl, cand_off, cand_dir, cand_pop = \
            dist.allgather_ragged_many(
                [cand_sg, cand_cl, cand_off, cand_dir, cand_pop])
    return cand_sg, cand_cl, cand_off, cand_dir, cand_pop


def _dedupe(cand_sg, cand_cl, cand_off, cand_dir, cand_pop):
    """Drop duplicate (sg, contig, off, dir) placements found via several
    dictionaries (first occurrence wins; pop is identical for duplicates)."""
    if len(cand_sg) == 0:
        return cand_sg, cand_cl, cand_off, cand_dir, cand_pop
    key = np.stack([cand_sg, cand_cl, cand_off,
                    cand_dir.astype(np.int64)], axis=1)
    _, uniq = np.unique(key, axis=0, return_index=True)
    uniq.sort()
    return tuple(x[uniq] for x in
                 (cand_sg, cand_cl, cand_off, cand_dir, cand_pop))


def _probe_and_verify(cset, wflat, wseg, woff, dicts, ranges, sg_words,
                      L, thr, max_search):
    """All (window x dict x strand) probes -> verified candidate arrays."""
    W = sg_words.shape[1]
    out = [[], [], [], [], []]
    CH = 1 << 16
    for s0 in range(0, len(wflat), CH):
        s1 = min(s0 + CH, len(wflat))
        wf, ws, wo = wflat[s0:s1], wseg[s0:s1], woff[s0:s1]
        win_idx = wf[:, None] + np.arange(L)[None, :]
        win_codes = cset.ref_flat[win_idx]              # [Wn, L]
        win_words = pack_2bit_words(win_codes)
        rc_codes = revcomp_codes(win_codes)
        rc_words = pack_2bit_words(rc_codes)
        for dno, (ds, de) in enumerate(ranges):
            seg_len = de - ds + 1
            for strand, wcodes, wwords in ((0, win_codes, win_words),
                                           (1, rc_codes, rc_words)):
                keys = _pack_key(wcodes, ds, seg_len)
                lo, cnt = dicts[dno].lookup(keys, max_search)
                tot = int(cnt.sum())
                if tot == 0:
                    continue
                rows = np.repeat(np.arange(len(keys)), cnt)
                hit = (np.repeat(lo, cnt)
                       + (np.arange(tot)
                          - np.repeat(np.cumsum(np.r_[0, cnt[:-1]]), cnt)))
                sg_idx = dicts[dno].order[hit]
                pop = popcount_u32(wwords[rows] ^ sg_words[sg_idx]).sum(axis=1)
                ok = pop <= thr
                out[0].append(sg_idx[ok])
                out[1].append(ws[rows[ok]])
                out[2].append(wo[rows[ok]])
                out[3].append(np.full(int(ok.sum()), strand, np.int8))
                out[4].append(pop[ok].astype(np.int32))
    if not out[0]:
        z = np.zeros(0, np.int64)
        return z, z, z, z.astype(np.int8), z.astype(np.int32)
    res = [np.concatenate(x) for x in out]
    # dedupe (same read found at same placement through several dicts)
    key = np.stack([res[0], res[1], res[2], res[3].astype(np.int64)], axis=1)
    _, uniq = np.unique(key, axis=0, return_index=True)
    return tuple(r[uniq] for r in res)


def _encode_cost_ok(cset, sgc, cand_sg, cand_cl, cand_off,
                    cand_dir, thr, L):
    """encode_byte rule: diff-string length <= 0.4*L. Forward placements are
    always checked; reverse placements only when threshold > 24
    (kthread_hash_realign.c:393,461). ``sgc`` = the materialized singleton
    rows (cand_sg indexes it)."""
    ok = np.ones(len(cand_sg), bool)
    check = (cand_dir == 0) | (thr > 24)
    rows = np.flatnonzero(check)
    if len(rows) == 0:
        return ok
    CH = 1 << 18
    for s in range(0, len(rows), CH):
        sel = rows[s:s + CH]
        win = (cset.ref_ptr[cand_cl[sel]] + cand_off[sel])[:, None] \
            + np.arange(L)[None, :]
        ref_rows = codes_to_ascii(cset.ref_flat[win])
        codes = sgc[cand_sg[sel]]
        rc = revcomp_codes(codes)
        oriented = np.where((cand_dir[sel] == 1)[:, None], rc, codes)
        lens = diff_encode_lengths(ref_rows, codes_to_ascii(oriented), 0)
        ok[sel] = lens <= 0.4 * L
    return ok


def _append_members(cs: ClusterSet, batches) -> ClusterSet:
    """Append claimed reads (rid, cluster, off, dir) to their clusters."""
    rid = np.concatenate([b[0] for b in batches])
    cl = np.concatenate([b[1] for b in batches])
    off = np.concatenate([b[2] for b in batches])
    dirs = np.concatenate([b[3] for b in batches])
    sizes = cs.cluster_sizes() + np.bincount(cl, minlength=cs.n_clusters)
    cptr = np.zeros(cs.n_clusters + 1, np.int64)
    np.cumsum(sizes, out=cptr[1:])
    M = int(cptr[-1])
    mem_rid = np.empty(M, np.int64)
    mem_off = np.empty(M, np.int32)
    mem_dir = np.empty(M, np.int8)
    # old members first within each cluster, then new (order is canonicalized
    # at serialization anyway)
    old_sizes = cs.cluster_sizes()
    old_dst = np.repeat(cptr[:-1] - cs.cluster_ptr[:-1], old_sizes) \
        + np.arange(cs.n_members)
    mem_rid[old_dst] = cs.mem_rid
    mem_off[old_dst] = cs.mem_off
    mem_dir[old_dst] = cs.mem_dir
    order = np.argsort(cl, kind="stable")
    ins_base = cptr[:-1] + old_sizes
    rank = np.arange(len(cl)) - np.repeat(
        np.cumsum(np.r_[0, np.bincount(cl, minlength=cs.n_clusters)[:-1]]),
        np.bincount(cl, minlength=cs.n_clusters))
    dst = ins_base[cl[order]] + rank
    mem_rid[dst] = rid[order]
    mem_off[dst] = off[order]
    mem_dir[dst] = dirs[order]
    return ClusterSet(cs.readlen, mem_rid, mem_off, mem_dir, cptr,
                      cs.ref_flat, cs.ref_ptr)

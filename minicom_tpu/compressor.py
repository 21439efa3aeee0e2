"""Top-level compress/decompress entry points (reference: minicommain.c +
preprocess.c orchestration).

compress():  classify -> cluster rounds -> contig merge -> realignment ladder
             -> serialize -> .mtc container.
decompress(): container -> streams -> mode-specific assembly.
"""

from __future__ import annotations

import os
import time

import numpy as np

from minicom_tpu.config import CompressorConfig
from minicom_tpu.io import container, fastq
from minicom_tpu.pipeline import classify as classify_mod
from minicom_tpu.pipeline import cluster as cluster_mod
from minicom_tpu.pipeline import decode as decode_mod
from minicom_tpu.pipeline import encode as encode_mod
from minicom_tpu.pipeline.merge import merge_contigs
from minicom_tpu.pipeline.realign import realign_ladder
from minicom_tpu.stats import StageStats


def compress(reads_path: str, out_path: str, cfg: CompressorConfig | None = None,
             reads_path2: str | None = None, stats: StageStats | None = None) -> dict:
    """Compress FASTQ file(s) into a .mtc archive; returns summary dict.

    Set MTC_TRACE_DIR to capture a jax.profiler trace of the device stages
    (viewable in TensorBoard/Perfetto — the SURVEY §5 profiling story)."""
    cfg = cfg or CompressorConfig()
    stats = stats or StageStats()
    trace_dir = os.environ.get("MTC_TRACE_DIR")
    if trace_dir:
        import jax
        jax.profiler.start_trace(trace_dir)
    try:
        return _compress(reads_path, out_path, cfg, reads_path2, stats)
    finally:
        if trace_dir:
            import jax
            jax.profiler.stop_trace()


def _compress(reads_path, out_path, cfg, reads_path2, stats) -> dict:

    with stats.stage("load"):
        half_val = 0
        if reads_path2 is not None:
            codes = fastq.read_fastq_codes(reads_path)
            codes2 = fastq.read_fastq_codes(reads_path2)
            if codes2.shape[1] != codes.shape[1]:
                raise ValueError("paired files have different read lengths")
            half_val = codes.shape[0]
            if codes2.shape[0] != half_val:
                raise ValueError("paired files contain different read counts")
            codes = np.concatenate([codes, codes2], axis=0)
            cfg.paired = True
            # multi-process: keep only this rank's row slice resident
            from minicom_tpu.parallel.store import maybe_shard
            codes = maybe_shard(codes)
        else:
            # single-process: plain matrix; multi-process: row-sharded store
            # (per-rank RSS = store/P — VERDICT r04 missing #4)
            codes = fastq.read_fastq_store(reads_path)
    n_seq, L = codes.shape
    rcfg = cfg.resolve(L if L else 1)
    if rcfg.threads > 0:  # -t: cap native OpenMP + entropy pool workers
        from minicom_tpu import native
        native.set_threads(rcfg.threads)
        container.set_threads(rcfg.threads)

    with stats.stage("classify"):
        cls = classify_mod.classify(codes, rcfg)
    del codes

    # stage checkpoint/resume: snapshots of the (ClusterSet, singletons)
    # state after each expensive stage; a rerun with the same input + config
    # resumes from the newest one (byte-identical archive — all stages are
    # deterministic). The reference has no analogue (SURVEY.md §5).
    ck = done = None
    if cfg.checkpoint_dir:
        from minicom_tpu.checkpoint import StageCheckpoint
        paths = [reads_path] + ([reads_path2] if reads_path2 else [])
        ck = StageCheckpoint(cfg.checkpoint_dir, paths, cfg)
        done, state = ck.latest()
        if done:
            cset, sg, extra = state
            stats.set("resumed_from", done)
    rank = {"cluster": 1, "merge": 2, "realign": 3}.get(done, 0)

    # the device path uploads the (N-substituted) read store ONCE; all
    # cluster rounds and the merge re-vote gather from it by rid (8 B/member
    # host->device instead of L+8), row-padded to a tier so XLA program
    # shapes are dataset-size independent
    from minicom_tpu.parallel import mesh
    codes_dev = None
    if rank < 2 and mesh.use_device(cls.codes_sub):
        codes_dev = mesh.upload_read_store(cls.codes_sub)
    if rank < 1:
        with stats.stage("cluster"):
            cset, sg = cluster_mod.cluster_rounds(cls.codes_sub, cls.pool,
                                                  rcfg, codes_dev)
        if ck:
            ck.save("cluster", cset, sg)
    stats.set("clusters_initial", cset.n_clusters)
    stats.set("singletons_initial", len(sg))

    # widen realign search when few singletons remain (preprocess.c:169-172)
    rcfg = cfg.resolve(L if L else 1, n_singletons=len(sg))

    if rank < 2:
        with stats.stage("merge"):
            cset = merge_contigs(cset, rcfg, stats.counters,
                                 codes_host=cls.codes_sub,
                                 codes_dev=codes_dev)
        if ck:
            ck.save("merge", cset, sg)
    del codes_dev
    stats.set("clusters_merged", cset.n_clusters)
    stats.set("consensus_bases", int(cset.ref_ptr[-1]))

    if rank < 3:
        with stats.stage("realign"):
            cset, sg, extra_a, extra_t = realign_ladder(
                cset, sg, cls.codes_sub, cls.n_mask, rcfg,
                stats=stats.counters)
        if ck:
            ck.save("realign", cset, sg,
                    {"extra_a": extra_a, "extra_t": extra_t})
    else:
        extra_a, extra_t = extra["extra_a"], extra["extra_t"]
    stats.set("singletons_final", len(sg))

    # leftover singles containing N join the single_N stream
    # (kthread_dump.c:396-404)
    with stats.stage("serialize"):
        sg_has_n = cls.has_n[sg]
        nfile = np.concatenate([cls.nfile, sg[sg_has_n]])
        single = sg[~sg_has_n]
        inp = encode_mod.EncodeInput(
            readlen=L, n_seq=n_seq, half_val=half_val,
            order=rcfg.order, paired=rcfg.paired,
            codes_sub=cls.codes_sub, n_mask=cls.n_mask,
            all_a=cls.all_a, all_t=cls.all_t, all_n=cls.all_n,
            near_a=np.concatenate([cls.near_a, extra_a]),
            near_t=np.concatenate([cls.near_t, extra_t]),
            mostly_n=cls.mostly_n, nfile=nfile, single=single,
            clusters=cset,
        )
        meta, streams = encode_mod.serialize(inp)

    with stats.stage("entropy"):
        total = container.write_container(out_path, meta, streams, rcfg.codec)
    stats.set("archive_bytes", total)
    stats.set("input_bytes", int(n_seq) * (L + 1))
    return stats.summary()


def decompress(archive_path: str, out_path: str,
               out_path2: str | None = None,
               stats: StageStats | None = None) -> dict:
    stats = stats or StageStats()
    with stats.stage("read_container"):   # archive read + entropy decode
        # output matrices are allocated + prefaulted on a side thread while
        # the (GIL-releasing) entropy decoders run: the ~500 MB of page
        # faults at 5M reads disappear from the assembly critical path
        pre = decode_mod.Prealloc(container.read_header(archive_path))
        meta, streams = container.read_container(
            archive_path,
            stats.counters if os.environ.get("MTC_DECODE_PROFILE") else None)
    from minicom_tpu.parallel import distributed as dist
    pid, nproc = dist.process_grid()
    i_write = (nproc == 1 or pid == 0
               or os.environ.get("MTC_WRITE_ALL_RANKS") == "1")
    if nproc == 1 and not meta["pe"] and not meta["order"]:
        # unordered single-process: finished row ranges STREAM to a writer
        # thread while later rows still decode (the reference's OpenMP
        # decode threads write as they go, decompress.c:1271-1296; a single
        # end-of-decode 500 MB write can stall for seconds on hosts that
        # throttle page-cache accept after writeback pressure)
        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=8)
        werr = []

        def _writer():
            try:
                with open(out_path, "wb") as f:
                    while True:
                        part = q.get()
                        if part is None:
                            return
                        f.write(memoryview(part).cast("B"))
            except BaseException as e:   # surface on join
                werr.append(e)
                while q.get() is not None:   # keep the producer unblocked
                    pass

        def _sink(part):
            if len(part):                    # empty views cannot cast
                q.put(part)

        wt = threading.Thread(target=_writer, daemon=True)
        wt.start()
        with stats.stage("decode"):
            decode_mod.assemble_unordered(meta, streams, stats.counters,
                                          pre=pre, sink=_sink)
        with stats.stage("write"):   # residual writer drain
            q.put(None)
            wt.join()
            if werr:
                raise werr[0]
        return stats.summary()

    with stats.stage("decode"):
        if meta["pe"]:
            f1, f2 = decode_mod.assemble_pe(meta, streams, pre=pre)
        elif meta["order"]:
            f1, f2 = decode_mod.assemble_order(meta, streams, pre=pre), None
        else:
            f1 = decode_mod.assemble_unordered(meta, streams, stats.counters,
                                               pre=pre)
            f2 = None
    with stats.stage("write"):   # assemble returns lines matrices: pure I/O
        # multi-process: every rank holds the identical output; rank 0
        # writes (MTC_WRITE_ALL_RANKS=1 restores per-rank writes — the
        # determinism test compares the bytes)
        if i_write:
            fastq.write_lines(out_path, f1)
            if f2 is not None:
                fastq.write_lines(out_path2 or out_path + ".2", f2)
        if nproc > 1:
            from jax.experimental import multihost_utils as mh
            mh.sync_global_devices("mtc_decode_write")
    return stats.summary()

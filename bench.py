"""Benchmark: encode+decode a synthetic SRR-style dataset.

Prints ONE JSON line:
  {"metric": "encode_MBps", "value": <warm encode MB/s>, "unit": "MB/s",
   "vs_baseline": <xz_bytes / mtc_bytes>, ...extras}

`vs_baseline` compares compressed size against raw `xz -9e` of the same
sequence stream (the strongest general-purpose codec available in-image; the
reference's whole pitch is beating generic compressors on read data — its
published numbers are sizes only, BASELINE.md). vs_baseline > 1 means the
minimizer-contig pipeline beats plain xz by that factor.
"""

from __future__ import annotations

import json
import lzma
import os
import sys
import tempfile
import time

import numpy as np


def _repeat_genome(rng, size: int) -> np.ndarray:
    """Random genome with realistic repeat structure: ~30% of 2 kb segments
    are near-copies (0.5% divergence) of earlier segments. Repeats are where
    minimizer-sharing across loci stresses the merge search (the reference's
    real inputs are repeat-rich genomes; a uniform-random genome understates
    candidate fan-out and overlap-scoring cost)."""
    seg = 2000
    n_seg = max(1, size // seg)
    parts = [rng.integers(0, 4, seg, dtype=np.uint8)]
    for _ in range(1, n_seg):
        if len(parts) > 1 and rng.random() < 0.30:
            src = parts[int(rng.integers(0, len(parts)))]
            dup = src.copy()
            mut = rng.random(seg) < 0.005
            dup[mut] = (dup[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            parts.append(dup)
        else:
            parts.append(rng.integers(0, 4, seg, dtype=np.uint8))
    return np.concatenate(parts)[:size]


def make_dataset(path: str, n_reads: int, L: int = 100,
                 coverage_genome: int = 0, err: float = 0.01,
                 seed: int = 7, profile: str | None = None) -> int:
    """Genome-sampled reads at ~50x coverage (a fixed tiny genome would make
    large n_reads trivially compressible and flatter the bench).

    profile="hard" (or BENCH_PROFILE=hard) is the second distribution the
    r03 verdict asked for: 150 bp reads, 2% substitution error, ~20x mean
    coverage with a skewed (power-law) sampling density over the genome —
    deep hotspots next to near-singleton deserts, the coverage shape real
    resequencing runs have. Every ratio/speed claim can then be checked
    against a generator the pipeline was not tuned on."""
    if profile is None:
        profile = os.environ.get("BENCH_PROFILE", "default")
    rng = np.random.default_rng(seed)
    if profile == "hard":
        L = 150
        err = 0.02
        if not coverage_genome:
            coverage_genome = max(600_000, n_reads * L // 20)
        genome = _repeat_genome(rng, coverage_genome)
        # skewed sampling: position weights from a coarse power-law field
        blocks = max(64, coverage_genome // 10_000)
        w = rng.pareto(1.2, blocks) + 0.05
        w /= w.sum()
        blk = rng.choice(blocks, n_reads, p=w)
        within = rng.integers(0, coverage_genome // blocks, n_reads)
        starts = np.minimum(blk * (coverage_genome // blocks) + within,
                            coverage_genome - L - 1)
    else:
        if not coverage_genome:
            coverage_genome = max(400_000, n_reads * L // 50)
        genome = _repeat_genome(rng, coverage_genome)
        starts = rng.integers(0, coverage_genome - L, n_reads)
    reads = genome[starts[:, None] + np.arange(L)]
    em = rng.random((n_reads, L)) < err
    reads = np.where(em, (reads + rng.integers(1, 4, (n_reads, L))) % 4,
                     reads).astype(np.uint8)
    flip = rng.random(n_reads) < 0.5
    reads[flip] = np.flip(3 - reads[flip], axis=1)
    txt = np.frombuffer(b"ACGT", np.uint8)[reads].copy()
    txt[rng.random((n_reads, L)) < 0.001] = ord("N")
    with open(path, "wb") as f:
        qual = b"I" * L
        for i in range(n_reads):
            f.write(b"@r%d\n" % i + txt[i].tobytes() + b"\n+\n" + qual + b"\n")
    return n_reads * (L + 1)


def _check_and_xz(fq: str, dec: str, q) -> None:
    a = sorted(open(fq, "rb").read().splitlines()[1::4])
    b = sorted(open(dec, "rb").read().splitlines())
    raw_seq = b"\n".join(a) + b"\n"
    xz_bytes = len(lzma.compress(raw_seq, preset=9 | lzma.PRESET_EXTREME))
    q.put((a == b, xz_bytes))


def main():
    n_reads = int(os.environ.get("BENCH_READS", "100000"))
    tmp = tempfile.mkdtemp(prefix="mtc_bench_")
    fq = os.path.join(tmp, "bench.fastq")
    arc = os.path.join(tmp, "bench.mtc")
    dec = os.path.join(tmp, "bench.dec")
    # generate in a child process so the harness's own big temporaries do not
    # inflate the compressor's peak-RSS metric
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=make_dataset, args=(fq, n_reads))
    p.start()
    p.join()
    if p.exitcode != 0:
        raise RuntimeError("dataset generation failed")
    L = len(open(fq, "rb").read(4096).splitlines()[1])
    seq_bytes = n_reads * (L + 1)

    from minicom_tpu import compressor

    # warmup run compiles every kernel; second run measures. os.sync()
    # between phases: the harness wrote a 1 GB dataset moments ago and each
    # phase writes hundreds of MB — without the barrier the measured phase
    # pays the PREVIOUS phase's dirty-page writeback (measured +3s of
    # phantom wall on the decode's output write)
    t0 = time.time()
    compressor.compress(fq, arc)
    cold_s = time.time() - t0
    from minicom_tpu.parallel import mesh
    mesh.reset_device_seconds()
    os.sync()
    t0 = time.time()
    summary = compressor.compress(fq, arc)
    warm_s = time.time() - t0
    device_s = mesh.device_seconds()
    device_bytes = mesh.device_bytes()
    mtc_bytes = os.path.getsize(arc)

    os.environ["MTC_DECODE_PROFILE"] = "1"   # per-stream entropy-decode split
    # no sync() here: a pre-decode sync leaves balance_dirty_pages throttling
    # page-cache accept to raw-disk speed for the next writer (measured: the
    # same 505 MB write costs 0.3s with a calm cache, 2.8s right after a
    # sync), and the reference decompress is timed without one either. The
    # decompressor also overlaps its output writes with decode (writer
    # thread), like the reference's per-thread OpenMP writes.
    t0 = time.time()
    dec_summary = compressor.decompress(arc, dec)
    dec_s = time.time() - t0

    # roundtrip check + xz baseline in a child process (both allocate far
    # more than the compressor's working set; keep them out of its peak RSS)
    q = ctx.Queue()
    p = ctx.Process(target=_check_and_xz, args=(fq, dec, q))
    p.start()
    roundtrip_ok, xz_bytes = q.get()
    p.join()

    # head-to-head vs the REFERENCE binary (built from /root/reference with
    # this input's config.h; its raw streams entropy-coded with the same
    # xz -9e that stands in for bsc — tools/ref_compare.py). Skipped
    # gracefully if the toolchain or reference tree is unavailable.
    ref = {}
    if os.environ.get("BENCH_REF", "1") != "0":
        try:
            sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
            from tools.ref_compare import run_reference
            r = run_reference(fq, threads=os.cpu_count() or 2)
            ref = {"ref_bytes": r["ref_stream_bytes"],
                   "ref_bytes_bwt": r["ref_stream_bytes_bwt"],
                   "ref_wall_s": r["ref_wall_s"],
                   "ref_decode_wall_s": r.get("ref_decode_wall_s"),
                   "ref_entropy_decode_proxy_s":
                       r.get("ref_entropy_decode_proxy_s"),
                   "size_vs_ref": round(r["ref_stream_bytes"] / mtc_bytes, 4),
                   # vs best-of(xz -9e, bz2 -9) per reference stream — the
                   # tighter, bsc-family-credible proxy (VERDICT r03 item 2)
                   "size_vs_ref_bwt": round(
                       r["ref_stream_bytes_bwt"] / mtc_bytes, 4)}
        except Exception as e:  # pragma: no cover
            ref = {"ref_error": str(e)[:200]}

    import resource
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    mb = seq_bytes / 1e6
    result = {
        "metric": "encode_MBps",
        "value": round(mb / warm_s, 3),
        "unit": "MB/s",
        "vs_baseline": round(xz_bytes / mtc_bytes, 4),
        "decode_MBps": round(mb / dec_s, 3),
        "cold_encode_s": round(cold_s, 2),
        "archive_bytes": mtc_bytes,
        "xz9e_bytes": xz_bytes,
        "ratio": round(seq_bytes / mtc_bytes, 3),
        "roundtrip_exact": bool(roundtrip_ok),
        "n_reads": n_reads,
        "profile": os.environ.get("BENCH_PROFILE", "default"),
        "peak_rss_bytes_per_base": round(peak_rss / (seq_bytes - n_reads), 2),
        # wall time the host spent blocked on device transfers/compute during
        # the warm encode, plus the bytes that crossed the host<->device link
        "device_time_fraction": round(device_s / warm_s, 4),
        "device_blocked_s": round(device_s, 3),
        "device_transfer_bytes": device_bytes,
        "stage_s": {k: round(v, 3) for k, v in summary["timings_s"].items()},
        # sub-stage wall splits inside merge/realign (the r03 dominators) —
        # the evidence layer for where encode time actually goes
        "sub_stage_s": {k: v for k, v in summary.items()
                        if k.endswith("_s") and isinstance(v, float)},
        "merge_probe_drops": summary.get("merge_probe_drops", 0),
        "merge_rank_saturated": summary.get("merge_rank_saturated", 0),
        "decode_stage_s": {
            **{k: round(v, 3)
               for k, v in dec_summary["timings_s"].items()},
            **{k: v for k, v in dec_summary.items()
               if k.endswith("_s") and isinstance(v, float)}},
        **ref,
    }
    print(json.dumps(result))
    if not roundtrip_ok:
        sys.exit(1)


if __name__ == "__main__":
    main()

"""Command-line interface — the reference's `minicom` shell driver
(minicom:405-489) as a single Python entry point.

    python -m minicom_tpu.cli -r reads.fastq [-o out.mtc] [flags]
    python -m minicom_tpu.cli -1 a_1.fastq -2 a_2.fastq [flags]
    python -m minicom_tpu.cli -d archive.mtc [-o out.reads]

Flags mirror the reference exactly: -t threads, -k kmer, -e diff threshold,
-m first minimizers, -w contig window, -s num dicts, -S step, -E max
threshold, -g merge threshold, -R max rounds, -p order-preserving.
No per-input recompilation, no external bsc/7z, no scratch dirs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from minicom_tpu.config import CompressorConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="minicom_tpu",
        description="lossless short-read (FASTQ) compressor")
    p.add_argument("-r", metavar="FASTQ", help="compress a single-end FASTQ")
    p.add_argument("-1", dest="pe1", metavar="FASTQ", help="paired-end mate 1")
    p.add_argument("-2", dest="pe2", metavar="FASTQ", help="paired-end mate 2")
    p.add_argument("-d", metavar="ARCHIVE", help="decompress a .mtc archive")
    p.add_argument("-o", metavar="OUT", help="output path")
    p.add_argument("-O", metavar="OUT2", help="second output path (PE decompress)")
    p.add_argument("-t", type=int, default=0, help="worker threads (0 = auto)")
    p.add_argument("-k", type=int, default=0, help="k-mer size (default 31; 17 if L<80)")
    p.add_argument("-e", type=int, default=4, help="mismatch budget per read")
    p.add_argument("-m", type=int, default=6, help="contig minimizers indexed")
    p.add_argument("-w", type=int, default=0, help="contig minimizer window")
    p.add_argument("-s", type=int, default=0, help="realign dictionaries")
    p.add_argument("-S", type=int, default=0, help="realign threshold step")
    p.add_argument("-E", type=int, default=0, help="realign threshold cap")
    p.add_argument("-g", type=int, default=0, help="contig-merge mismatch cap")
    p.add_argument("-R", type=int, default=35, help="max clustering rounds")
    p.add_argument("-p", action="store_true", help="order-preserving mode")
    p.add_argument("--codec", default="auto",
                   choices=["auto", "device", "xz", "o1rc", "o2rc", "dnarc",
                            "dz", "trans", "trans1", "trans2", "dzt",
                            "bz2", "zlib", "store"],
                   help="entropy backend per stream (auto = best host codec "
                        "per stream; device = the on-chip rANS family)")
    p.add_argument("--no-merge-revote", action="store_true",
                   help="splice merged contigs instead of re-voting all "
                        "members (faster, slightly larger archives)")
    p.add_argument("--merge-rank-cap", type=int, default=0, metavar="N",
                   help="max minimizers probed per contig during merge "
                        "(0 = auto)")
    p.add_argument("--merge-probe-cap", type=int, default=0, metavar="N",
                   help="max index hits walked per merge probe (0 = auto)")
    p.add_argument("--checkpoint", metavar="DIR", default=None,
                   help="stage checkpoint dir; reruns resume from the newest "
                        "completed stage (same input + flags required)")
    p.add_argument("--stats", action="store_true", help="print JSON stats")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from minicom_tpu import compressor  # defer heavy import

    cfg = CompressorConfig(
        k=args.k, diff_threshold=args.e, first_minimizers=args.m,
        contig_window=args.w, num_dicts=args.s, thr_step=args.S,
        max_threshold=args.E, cb_threshold=args.g, max_rounds=args.R,
        order=args.p, threads=args.t, codec=args.codec,
        checkpoint_dir=args.checkpoint,
        merge_revote=not args.no_merge_revote,
        merge_rank_cap=args.merge_rank_cap,
        merge_probe_cap=args.merge_probe_cap)

    if args.d:
        out = args.o or os.path.splitext(args.d)[0] + "_dec.reads"
        summary = compressor.decompress(args.d, out, args.O)
        if args.stats:
            print(json.dumps(summary))
        print(f"Decompressed to {out}")
        return 0
    if args.r:
        out = args.o or args.r + ".mtc"
        summary = compressor.compress(args.r, out, cfg)
        if args.stats:
            print(json.dumps(summary))
        print(f"Compressed to {out} ({summary['archive_bytes']} bytes, "
              f"{summary['input_bytes'] / summary['archive_bytes']:.2f}x)")
        return 0
    if args.pe1 and args.pe2:
        out = args.o or args.pe1 + ".mtc"
        summary = compressor.compress(args.pe1, out, cfg, reads_path2=args.pe2)
        if args.stats:
            print(json.dumps(summary))
        print(f"Compressed to {out} ({summary['archive_bytes']} bytes)")
        return 0
    build_parser().print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())

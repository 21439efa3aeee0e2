"""Smoke test of the compressor's device path on one GPU.

Run from the root of a checkout, on a machine whose JAX backend is a GPU:

    python chip_smoke.py                 # one card: phases 0-4
    python chip_smoke.py --reads 200000  # smaller phase-2/3 input
    python chip_smoke.py --four-gpus     # the mesh path over four cards only

Phases, in order (any failure exits non-zero):
  0. device: JAX version, backend, device kind and count, the card's name and
     power limit; fails unless the backend is a GPU and the native library
     (the reference twins below) loads.
  1. the ``gpu``-marked tests, in a subprocess that ends before this process
     imports JAX (a JAX process reserves most of the card when it starts, so
     two must never hold it at once).
  2. kernel parity at real widths: each device kernel against its native C++
     twin. All of this work is integer and no matrix product is involved (so
     TF32 does not apply): every comparison is exact equality.
  3. the main path: compressor.compress cold and warm, then decompress, on
     1M x 100 bp reads (bench.make_dataset, default profile, seed 7). The
     device path must run, the roundtrip must be exact, and the archive must
     equal, byte for byte, the host-path archive that a JAX_PLATFORMS=cpu
     subprocess makes of the same input.
  4. order-preserving (-p), paired-end (-1/-2) and --codec device through
     cli.main in this process, on 200k reads; the device-codec archive must
     equal the one a JAX_PLATFORMS=cpu subprocess makes.

``--four-gpus`` runs only the mesh path: the phase-3 input compressed over a
4-device mesh must equal the 1-device-mesh archive and roundtrip exactly.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_PEAK_BPS = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def run(cmd: list[str], cpu: bool = False,
        timeout: float = 900) -> subprocess.CompletedProcess:
    """Run a child from the checkout root; ``cpu`` holds its JAX to the CPU
    so it never opens the card."""
    env = dict(os.environ)
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    if r.returncode != 0:
        fail(f"{' '.join(cmd[:4])} ... exited {r.returncode}:\n"
             f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return r


def _timed(label: str, fn):
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    say(f"  {label}: {dt:.3f} s")
    return out, dt


# ---------------------------------------------------------------------------
# phase 0 and 1: no JAX in this process yet

_PROBE = """
import json, jax
from minicom_tpu import native
d = jax.devices()
print(json.dumps({"jax": jax.__version__, "backend": jax.default_backend(),
                  "kind": d[0].device_kind, "count": len(d),
                  "native": native.has_native()}))
"""


def phase0() -> dict:
    say("phase 0: device")
    if not os.path.isdir(os.path.join(ROOT, "minicom_tpu")):
        fail(f"no minicom_tpu package beside {__file__}: run from a checkout")
    r = run([sys.executable, "-c", _PROBE], timeout=600)
    info = json.loads(r.stdout.strip().splitlines()[-1])
    say(f"  jax {info['jax']}  backend {info['backend']}  "
        f"device_kind {info['kind']}  devices {info['count']}")
    if info["backend"] != "gpu":
        fail(f"needs a GPU backend; JAX found {info['backend']}")
    if not info["native"]:
        fail("the native library did not build or load (g++ with OpenMP is "
             "needed): its kernels are the reference of phase 2")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"], timeout=60)
    info["card"] = smi.stdout.strip().splitlines()[0]
    for line in smi.stdout.strip().splitlines():
        say(f"  card: {line}")
    return info


def phase1() -> None:
    say("phase 1: gpu-marked tests")
    t0 = time.perf_counter()
    r = run([sys.executable, "-m", "pytest", "tests/test_gpu.py", "-m", "gpu",
             "-q", "-rs", "-p", "no:cacheprovider"], timeout=900)
    tail = r.stdout.strip().splitlines()[-1]
    if "passed" not in tail or "skipped" in tail:
        fail(f"gpu tests did not all run and pass: {tail}")
    say(f"  {tail} ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 2: device kernels vs native twins

def _sync(x):
    import jax
    return jax.block_until_ready(x)


def phase2(codes_sub, pool) -> None:
    import jax.numpy as jnp
    import numpy as np
    from minicom_tpu import native
    from minicom_tpu.ops.sketch import (gather_contig_rows,
                                        sketch_reads_dyn_gather_packed,
                                        sketch_windowed_compact32)
    from minicom_tpu.parallel import mesh
    from minicom_tpu.pipeline.cluster import _consensus_chunk
    from minicom_tpu.pipeline.merge import _RANK_CAP, _batch_m, _rows_tile

    say(f"phase 2: kernel parity ({len(codes_sub)} x {codes_sub.shape[1]} "
        "reads; exact equality)")
    N, L = codes_sub.shape
    store = mesh.upload_read_store(codes_sub)
    step = 1 << 17
    rids = np.zeros(-(-N // step) * step, np.int32)
    rids[:N] = np.arange(N)
    batches = [jnp.asarray(rids[s:s + step])
               for s in range(0, len(rids), step)]
    for k in (31, 17):
        def dev():
            return _sync([sketch_reads_dyn_gather_packed(store, b, k)
                          for b in batches])
        dev()                                    # compile
        outs, _ = _timed(f"read sketch k={k} device", dev)
        host, _ = _timed(
            f"read sketch k={k} native",
            lambda: native.sketch_reads_host(codes_sub, np.arange(N), k))
        got = np.concatenate([np.asarray(o) for o in outs], axis=1)[:, :N]
        hi, lo, pos, strand = host
        meta = (pos.astype(np.uint32) << 1) | strand.astype(np.uint32)
        for a, b, name in ((got[0], hi, "kmer_hi"), (got[1], lo, "kmer_lo"),
                           (got[2], meta, "pos|strand")):
            if not np.array_equal(a, b):
                fail(f"read sketch k={k}: {name} differs from native "
                     f"({int((a != b).sum())} of {N})")

    # the merge stage's three ladder rungs, at the tile shapes it dispatches
    rng = np.random.default_rng(7)
    k, w = 31, 19
    ref = rng.integers(0, 4, 1 << 22, dtype=np.uint8)
    ref_dev = mesh.replicate(jnp.asarray(ref))
    for Lmax in (128, 512, 2048):
        rows, m = _rows_tile(Lmax), _batch_m(Lmax, k, w, _RANK_CAP)
        lens = rng.integers(Lmax // 4 + 1, Lmax + 1, rows).astype(np.int32)
        starts = rng.integers(0, len(ref) - Lmax, rows).astype(np.int32)
        codes, ln = _sync(gather_contig_rows(
            ref_dev, jnp.asarray(np.stack([starts, lens])), Lmax))
        _sync(sketch_windowed_compact32(codes, ln, k, w, m))   # compile
        reps = 50
        t0 = time.perf_counter()
        for _ in range(reps):
            buf = sketch_windowed_compact32(codes, ln, k, w, m)
        _sync(buf)
        dt = (time.perf_counter() - t0) / reps
        nbytes = rows * Lmax + rows * 4 + (2 * rows * m + rows) * 4
        say(f"  windowed sketch {rows}x{Lmax} m={m}: {dt * 1e6:.1f} us/call, "
            f"{nbytes / dt / 1e9:.2f} GB/s moved at least, "
            f"{nbytes / dt / HBM_PEAK_BPS:.4%} of 3.35 TB/s")
        buf = np.asarray(buf)
        nk, nm, nnv = native.sketch_windowed_host(
            ref, starts, lens, k, np.full(rows, w, np.int32),
            np.full(rows, m, np.int32), m)
        cm = rows * m
        v = (np.arange(m)[None, :] < nnv[:, None]).reshape(-1)
        if not (np.array_equal(buf[2 * cm:].view(np.int32), nnv)
                and np.array_equal(buf[:cm][v], nk.reshape(-1)[v])
                and np.array_equal(buf[cm:2 * cm].view(np.int32)[v],
                                   nm.reshape(-1)[v])):
            fail(f"windowed sketch rung {Lmax} differs from native")

    # consensus + member diffs over the members of one cluster round (k=31)
    k = 31
    hi, lo, pos, strand = native.sketch_reads_host(codes_sub, pool, k)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    mpos = np.where(strand == 1, L - pos + k - 2, pos).astype(np.int64)
    o = np.lexsort((pool, -mpos, key))
    key, mpos, dirs, rid = key[o], mpos[o], strand[o], pool[o]
    seg = np.cumsum(np.r_[True, key[1:] != key[:-1]]) - 1
    keep = np.bincount(seg)[seg] >= 2
    key, mpos, dirs, rid = key[keep], mpos[keep], dirs[keep], rid[keep]
    first = np.r_[True, key[1:] != key[:-1]]
    seg = np.cumsum(first) - 1
    off = (mpos[first][seg] - mpos).astype(np.int32)
    span = np.zeros(seg[-1] + 1, np.int64)
    np.maximum.at(span, seg, off.astype(np.int64) + L)
    colptr = np.r_[0, np.cumsum(span)]
    total = int(colptr[-1])
    segptr = np.r_[np.flatnonzero(first), len(seg)]
    _consensus_chunk(L, colptr[seg].astype(np.int32), off, rid, dirs, total,
                     store)                                      # compile
    (ref_d, diffs_d), _ = _timed(
        f"consensus device ({len(rid)} members, {total} columns)",
        lambda: _consensus_chunk(L, colptr[seg].astype(np.int32), off, rid,
                                 dirs, total, store))
    (ref_h, diffs_h), _ = _timed(
        "consensus native",
        lambda: native.consensus_host(
            codes_sub, (rid * 2 + dirs).astype(np.int32), colptr[seg] + off,
            segptr, colptr, total, True, True))
    if not np.array_equal(ref_d, ref_h):
        fail("consensus differs from native")
    if not np.array_equal(diffs_d, diffs_h):
        fail("member diffs differ from native")
    say("  all kernels equal their native twins")


# ---------------------------------------------------------------------------
# phase 3 and 4: the user's entry points

def _seqs(path: str) -> list[bytes]:
    """Sequence lines of a FASTQ file."""
    with open(path, "rb") as f:
        return f.read().splitlines()[1::4]


def _lines(path: str) -> list[bytes]:
    with open(path, "rb") as f:
        return f.read().splitlines()


def _same(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase3(fq: str, tmp: str) -> None:
    from minicom_tpu import compressor
    from minicom_tpu.parallel import mesh

    say("phase 3: main path")
    host_arc = os.path.join(tmp, "host.mtc")
    _timed("host-path compress (JAX_PLATFORMS=cpu subprocess)", lambda: run(
        [sys.executable, "-c", "import sys; from minicom_tpu import "
         "compressor; compressor.compress(sys.argv[1], sys.argv[2])",
         fq, host_arc], cpu=True, timeout=900))
    arc = os.path.join(tmp, "dev.mtc")
    _timed("compress cold", lambda: compressor.compress(fq, arc))
    mesh.reset_device_seconds()
    summary, warm = _timed("compress warm",
                           lambda: compressor.compress(fq, arc))
    say(f"  warm stages (s): {json.dumps(summary['timings_s'])}")
    say(f"  warm device-blocked {mesh.device_seconds():.3f} s, "
        f"{mesh.device_bytes()} bytes host<->device, "
        f"archive {summary['archive_bytes']} bytes")
    if mesh.device_bytes() <= 0:
        fail("the warm encode moved no bytes to or from the device")
    dec = os.path.join(tmp, "dev.reads")
    dsum, _ = _timed("decompress", lambda: compressor.decompress(arc, dec))
    say(f"  decode stages (s): {json.dumps(dsum['timings_s'])}")
    if sorted(_seqs(fq)) != sorted(_lines(dec)):
        fail("roundtrip is not exact")
    if not _same(arc, host_arc):
        fail("device-path archive differs from the host-path archive")
    say("  roundtrip exact; archive equals the host-path archive")


def phase4(fq: str, tmp: str) -> None:
    from minicom_tpu import cli

    say("phase 4: other modes and the on-chip codec")
    seqs = _seqs(fq)
    arc, out = os.path.join(tmp, "p.mtc"), os.path.join(tmp, "p.reads")
    _timed("-p compress", lambda: cli.main(["-r", fq, "-o", arc, "-p"]))
    _timed("-p decompress", lambda: cli.main(["-d", arc, "-o", out]))
    if _lines(out) != seqs:
        fail("-p roundtrip is not exact")

    with open(fq, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    half = (len(lines) // 8) * 4
    m1, m2 = os.path.join(tmp, "m_1.fastq"), os.path.join(tmp, "m_2.fastq")
    with open(m1, "wb") as f:
        f.writelines(lines[:half])
    with open(m2, "wb") as f:
        f.writelines(lines[half:2 * half])
    arc, o1, o2 = (os.path.join(tmp, n) for n in ("pe.mtc", "1.r", "2.r"))
    _timed("-1/-2 compress",
           lambda: cli.main(["-1", m1, "-2", m2, "-o", arc]))
    _timed("-1/-2 decompress",
           lambda: cli.main(["-d", arc, "-o", o1, "-O", o2]))
    if (sorted(zip(_lines(o1), _lines(o2)))
            != sorted(zip(_seqs(m1), _seqs(m2)))):
        fail("-1/-2 roundtrip is not exact")

    arc, out = os.path.join(tmp, "c.mtc"), os.path.join(tmp, "c.reads")
    cpu_arc = os.path.join(tmp, "c_cpu.mtc")
    _timed("--codec device compress",
           lambda: cli.main(["-r", fq, "-o", arc, "--codec", "device"]))
    _timed("--codec device decompress",
           lambda: cli.main(["-d", arc, "-o", out]))
    if sorted(_lines(out)) != sorted(seqs):
        fail("--codec device roundtrip is not exact")
    _timed("--codec device compress (JAX_PLATFORMS=cpu subprocess)",
           lambda: run([sys.executable, "-m", "minicom_tpu.cli", "-r", fq,
                        "-o", cpu_arc, "--codec", "device"], cpu=True,
                       timeout=900))
    if not _same(arc, cpu_arc):
        fail("--codec device archive differs between GPU and CPU")
    say("  -p, -1/-2 and --codec device roundtrips exact; device codec "
        "archive equals the CPU one")


def four_gpus(fq: str, tmp: str) -> None:
    import jax
    from minicom_tpu import compressor
    from minicom_tpu.parallel import mesh

    if len(jax.devices()) < 4:
        fail(f"--four-gpus needs 4 devices, JAX found {len(jax.devices())}")
    say("four GPUs: mesh path")
    arcs = {}
    try:
        for n in (1, 4):
            mesh.set_mesh(mesh.make_mesh(n))
            arcs[n] = os.path.join(tmp, f"mesh{n}.mtc")
            _timed(f"{n}-device mesh compress cold",
                   lambda: compressor.compress(fq, arcs[n]))
            mesh.reset_device_seconds()
            s, _ = _timed(f"{n}-device mesh compress warm",
                          lambda: compressor.compress(fq, arcs[n]))
            say(f"  warm stages (s): {json.dumps(s['timings_s'])}")
    finally:
        mesh.set_mesh(None)
    if not _same(arcs[1], arcs[4]):
        fail("4-device archive differs from the 1-device archive")
    dec = os.path.join(tmp, "mesh4.reads")
    _timed("decompress", lambda: compressor.decompress(arcs[4], dec))
    if sorted(_seqs(fq)) != sorted(_lines(dec)):
        fail("4-device roundtrip is not exact")
    say("  4-device archive equals the 1-device archive; roundtrip exact")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=1_000_000,
                    help="reads in the phase-2/3 input (default 1M)")
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-device mesh path")
    args = ap.parse_args()
    t_start = time.perf_counter()

    info = phase0()
    if not args.four_gpus:
        phase1()

    sys.path.insert(0, ROOT)
    import jax
    if jax.default_backend() != "gpu":
        fail(f"needs a GPU backend; JAX found {jax.default_backend()}")
    import bench
    from minicom_tpu.config import CompressorConfig
    from minicom_tpu.io import fastq
    from minicom_tpu.pipeline import classify

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fq = os.path.join(tmp, "in.fastq")
        _timed(f"make_dataset {args.reads} reads (seed 7)",
               lambda: bench.make_dataset(fq, args.reads, seed=7,
                                          profile="default"))
        if args.four_gpus:
            four_gpus(fq, tmp)
        else:
            codes = fastq.read_fastq_codes(fq)
            cls = classify.classify(codes,
                                    CompressorConfig().resolve(codes.shape[1]))
            phase2(cls.codes_sub, cls.pool)
            del codes, cls
            phase3(fq, tmp)
            fq4 = os.path.join(tmp, "in200k.fastq")
            bench.make_dataset(fq4, 200_000, seed=7, profile="default")
            phase4(fq4, tmp)
    say(f"card: {info['card']}; total {time.perf_counter() - t_start:.1f} s")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()

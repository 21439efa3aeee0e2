"""Device path on a GPU: archives equal the host path's, and the device
kernels equal their native C++ twins. Skipped unless JAX's backend is a GPU;
run alone with

    python -m pytest tests/test_gpu.py -m gpu -q

Every kernel here is integer work, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from minicom_tpu import compressor, native
from minicom_tpu.config import CompressorConfig
from minicom_tpu.parallel import mesh
from tests.conftest import genome_reads, write_fastq

pytestmark = pytest.mark.gpu


def test_device_archive_matches_host(gpu, tmp_path, rng, monkeypatch):
    assert mesh.use_device()
    reads = genome_reads(rng, 3000, 100, genome_len=8000, err=0.01,
                         p_n=0.002)
    fq = str(tmp_path / "in.fastq")
    write_fastq(fq, reads)
    mesh.reset_device_seconds()
    compressor.compress(fq, str(tmp_path / "dev.mtc"), CompressorConfig())
    assert mesh.device_bytes() > 0
    monkeypatch.setattr(mesh, "use_device", lambda store=None: False)
    compressor.compress(fq, str(tmp_path / "host.mtc"), CompressorConfig())
    assert ((tmp_path / "dev.mtc").read_bytes()
            == (tmp_path / "host.mtc").read_bytes())
    monkeypatch.undo()
    out = str(tmp_path / "dec.reads")
    compressor.decompress(str(tmp_path / "dev.mtc"), out)
    assert (sorted(open(out, "rb").read().splitlines())
            == sorted(bytes(r) for r in reads))


@pytest.mark.parametrize("k", [31, 17])
def test_read_sketch_matches_native(gpu, rng, k):
    from minicom_tpu.ops.sketch import sketch_reads_dyn_gather_packed
    codes = rng.integers(0, 4, (1 << 13, 100), dtype=np.uint8)
    rids = rng.permutation(len(codes)).astype(np.int32)
    dev = np.asarray(sketch_reads_dyn_gather_packed(
        mesh.upload_read_store(codes), jnp.asarray(rids), k))
    hi, lo, pos, strand = native.sketch_reads_host(codes, rids, k)
    np.testing.assert_array_equal(dev[0], hi)
    np.testing.assert_array_equal(dev[1], lo)
    np.testing.assert_array_equal(dev[2], (pos.astype(np.uint32) << 1)
                                  | strand.astype(np.uint32))


def test_windowed_sketch_matches_native(gpu, rng):
    from minicom_tpu.ops.sketch import (gather_contig_rows,
                                        sketch_windowed_compact32)
    from minicom_tpu.pipeline.merge import _RANK_CAP, _batch_m
    k, w = 31, 19
    ref = rng.integers(0, 4, 1 << 20, dtype=np.uint8)
    for Lmax, rows in ((128, 2048), (512, 2048), (2048, 2048)):
        m = _batch_m(Lmax, k, w, _RANK_CAP)
        lens = rng.integers(Lmax // 4 + 1, Lmax + 1, rows).astype(np.int32)
        starts = rng.integers(0, len(ref) - Lmax, rows).astype(np.int32)
        codes, ln = gather_contig_rows(
            jnp.asarray(ref), jnp.asarray(np.stack([starts, lens])), Lmax)
        buf = np.asarray(sketch_windowed_compact32(codes, ln, k, w, m))
        nk, nm, nnv = native.sketch_windowed_host(
            ref, starts, lens, k, np.full(rows, w, np.int32),
            np.full(rows, m, np.int32), m)
        cm = rows * m
        np.testing.assert_array_equal(buf[2 * cm:].view(np.int32), nnv)
        v = (np.arange(m)[None, :] < nnv[:, None]).reshape(-1)
        np.testing.assert_array_equal(buf[:cm][v], nk.reshape(-1)[v])
        np.testing.assert_array_equal(buf[cm:2 * cm].view(np.int32)[v],
                                      nm.reshape(-1)[v])


def test_consensus_matches_native(gpu, rng):
    from minicom_tpu.pipeline.cluster import _consensus_chunk
    L, n_seg = 100, 3000
    codes = rng.integers(0, 4, (1 << 15, L), dtype=np.uint8)
    sizes = rng.integers(2, 40, n_seg)
    seg = np.repeat(np.arange(n_seg), sizes)
    rids = rng.integers(0, len(codes), len(seg)).astype(np.int64)
    dirs = rng.integers(0, 2, len(seg)).astype(np.int8)
    off = rng.integers(0, 60, len(seg)).astype(np.int32)
    off[np.r_[0, np.cumsum(sizes)[:-1]]] = 0      # every segment has col 0
    span = np.zeros(n_seg, np.int64)
    np.maximum.at(span, seg, off.astype(np.int64) + L)
    colptr = np.r_[0, np.cumsum(span)]
    total = int(colptr[-1])
    ref_d, diffs_d = _consensus_chunk(
        L, (colptr[seg]).astype(np.int32), off, rids, dirs, total,
        mesh.upload_read_store(codes))
    ref_h, diffs_h = native.consensus_host(
        codes, (rids * 2 + dirs).astype(np.int32), colptr[seg] + off,
        np.r_[0, np.cumsum(sizes)], colptr, total, True, True)
    np.testing.assert_array_equal(ref_d, ref_h)
    np.testing.assert_array_equal(diffs_d, diffs_h)

"""Sketch kernels vs a tiny pure-Python oracle of the canonical spec.

The k-mer/strand/palindrome semantics transcribe sketch.c:238-289; the ranking
hash is this package's own 32-bit avalanche (ops/sketch.py mix32) since device
code here is 32-bit by convention and the reference's hash64 is 64-bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from minicom_tpu.ops import sketch as sk

M32 = 0xFFFFFFFF


def oracle_mix32(hi, lo):
    h = ((hi * 0x9E3779B1) & M32) ^ ((lo * 0x85EBCA77) & M32)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    h ^= h >> 16
    return h


def oracle_kmers(codes, k):
    """All (h32, kmer, end_pos, strand) canonical k-mers (skips palindromes)."""
    mask = (1 << (2 * k)) - 1
    shift1 = 2 * (k - 1)
    kf = kr = 0
    out = []
    for i, c in enumerate(codes):
        c = int(c)
        kf = ((kf << 2) | c) & mask
        kr = (kr >> 2) | ((3 ^ c) << shift1)
        if kf == kr:
            continue
        z = 0 if kf < kr else 1
        if i >= k - 1:
            km = kf if z == 0 else kr
            out.append((oracle_mix32(km >> 32, km & M32), km, i, z))
    return out


def oracle_sketch_two(codes, k):
    kmers = oracle_kmers(codes, k)
    # first position wins hash ties (strict-< update in the reference loop)
    return min(kmers, key=lambda t: (t[0], t[2])) if kmers else None


def test_mix32_matches_oracle(rng):
    hi = rng.integers(0, 1 << 32, size=64, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, size=64, dtype=np.uint32)
    got = np.asarray(sk.mix32(jnp.asarray(hi), jnp.asarray(lo)))
    for a, b, g in zip(hi, lo, got):
        assert int(g) == oracle_mix32(int(a), int(b))


@pytest.mark.parametrize("k", [4, 17, 31])
def test_sketch_reads_matches_oracle(rng, k):
    codes = rng.integers(0, 4, size=(40, 64)).astype(np.uint8)
    h, khi, klo, pos, strand = (np.asarray(x)
                                for x in sk.sketch_reads(jnp.asarray(codes), k))
    for i in range(40):
        o = oracle_sketch_two(codes[i], k)
        assert o is not None
        km = (int(khi[i]) << 32) | int(klo[i])
        assert (int(h[i]), km, int(pos[i]), int(strand[i])) == o


def test_sketch_reads_revcomp_invariant(rng):
    """A read and its reverse complement share the canonical minimizer."""
    k, L = 17, 80
    codes = rng.integers(0, 4, size=(20, L)).astype(np.uint8)
    rc = np.flip(3 - codes, axis=1).astype(np.uint8)
    h1, hi1, lo1, p1, s1 = (np.asarray(x) for x in sk.sketch_reads(jnp.asarray(codes), k))
    h2, hi2, lo2, p2, s2 = (np.asarray(x) for x in sk.sketch_reads(jnp.asarray(rc), k))
    assert np.array_equal(h1, h2)
    assert np.array_equal(hi1, hi2) and np.array_equal(lo1, lo2)
    assert np.array_equal(s1, 1 - s2)
    # end positions mirror: the minimizer occupies the same bases
    assert np.array_equal(p2, L - 1 - (p1 - k + 1))


def oracle_windowed_set(codes, k, w):
    """Minimizer position set: i emitted iff h[i] == min over some window.

    Windows start at every k-mer position and are clipped at the row end
    (the trailing partial windows mirror the reference's final-min push,
    sketch.c:163-164)."""
    kmers = oracle_kmers(codes, k)
    H = {i: h for h, _km, i, _z in kmers}
    S = len(codes) - k + 1
    we = min(w, S)
    emitted = set()
    for s in range(0, S):
        win = range(s, min(s + we, S))
        vals = [H[i + k - 1] for i in win if i + k - 1 in H]
        if not vals:
            continue
        m = min(vals)
        for i in win:
            if H.get(i + k - 1) == m:
                emitted.add(i + k - 1)
    return sorted(emitted)


@pytest.mark.parametrize("k,w", [(5, 3), (17, 8)])
def test_sketch_windowed_matches_oracle(rng, k, w):
    C, L = 12, 90
    codes = rng.integers(0, 4, size=(C, L)).astype(np.uint8)
    lengths = rng.integers(k + w + 3, L + 1, size=C).astype(np.int32)
    m = 64
    h, khi, klo, pos, strand, valid = (np.asarray(x) for x in sk.sketch_windowed(
        jnp.asarray(codes), jnp.asarray(lengths), k, w, m))
    for c in range(C):
        want = oracle_windowed_set(codes[c][:lengths[c]], k, w)[:m]
        got = list(pos[c][valid[c]])
        assert got == want, f"contig {c}"
        H = {i: hh for hh, _km, i, _z in oracle_kmers(codes[c][:lengths[c]], k)}
        for hh, p in zip(h[c][valid[c]], got):
            assert int(hh) == H[p]


def test_sketch_windowed_short_contig(rng):
    # fewer k-mers than the window: clipped windows still emit suffix minima
    k, w = 5, 16
    codes = rng.integers(0, 4, size=(3, 12)).astype(np.uint8)
    lengths = np.array([12, 12, 12], np.int32)
    h, khi, klo, pos, strand, valid = (np.asarray(x) for x in sk.sketch_windowed(
        jnp.asarray(codes), jnp.asarray(lengths), k, w, 4))
    for c in range(3):
        assert valid[c].sum() >= 1


@pytest.mark.parametrize("k", [4, 17, 31])
def test_sketch_reads_dyn_matches_static(rng, k):
    codes = rng.integers(0, 4, size=(30, 64)).astype(np.uint8)
    a = [np.asarray(x) for x in sk.sketch_reads(jnp.asarray(codes), k)]
    b = [np.asarray(x) for x in sk.sketch_reads_dyn(jnp.asarray(codes), k)]
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_native_windowed_matches_xla(rng):
    """The native host sketch (sketch.cpp — the single-chip merge fast path)
    emits buffers bit-identical to the XLA windowed sketch: same keys, meta
    and counts for every row, including short rows, palindromic k-mers and
    rows shorter than k."""
    from minicom_tpu import native
    from minicom_tpu.ops.sketch import sketch_windowed_compact32
    if not native.has_native():
        pytest.skip("native toolchain unavailable")

    ref = rng.integers(0, 4, 4096, dtype=np.uint8)
    for k, w, m, Lmax in [(17, 11, 48, 512), (31, 19, 24, 256),
                          (4, 3, 16, 128)]:
        starts = rng.integers(0, 2048, 40).astype(np.int64)
        lengths = rng.integers(1, Lmax + 1, 40).astype(np.int32)
        we = min(w, Lmax - k + 1)
        codes = np.zeros((40, Lmax), np.uint8)
        for i in range(40):
            codes[i, :lengths[i]] = ref[starts[i]:starts[i] + lengths[i]]
        buf = np.asarray(sketch_windowed_compact32(
            jnp.asarray(codes), jnp.asarray(lengths), k, we, m))
        cm = 40 * m
        xk = buf[:cm].reshape(40, m)
        xm = buf[cm:2 * cm].view(np.int32).reshape(40, m)
        xnv = buf[2 * cm:].view(np.int32)
        nk, nm, nnv = native.sketch_windowed_host(
            ref, starts, lengths, k,
            np.full(40, we, np.int32), np.full(40, m, np.int32), m)
        np.testing.assert_array_equal(xnv, nnv)
        v = np.arange(m)[None, :] < xnv[:, None]
        np.testing.assert_array_equal(xk[v], nk[v])
        np.testing.assert_array_equal(xm[v], nm[v])


def test_native_reads_sketch_matches_device(rng):
    """The native whole-read minimizer (sketch.cpp sketch_reads_host — the
    cluster stage's single-chip fast path) matches sketch_reads_dyn exactly,
    including the canonical empty record for reads with no valid k-mer."""
    from minicom_tpu import native
    if not native.has_native():
        pytest.skip("native toolchain unavailable")
    for k in (4, 17, 30, 31):
        codes = rng.integers(0, 4, size=(200, 64)).astype(np.uint8)
        if k == 30:  # force some all-palindromic rows (even k)
            codes[:5] = np.tile([0, 3], 32)[None, :]
        h, hi, lo, pos, strand = (np.asarray(x) for x in
                                  sk.sketch_reads_dyn(jnp.asarray(codes), k))
        rids = np.arange(200, dtype=np.int64)
        nhi, nlo, npos, nz = native.sketch_reads_host(codes, rids, k)
        np.testing.assert_array_equal(hi, nhi)
        np.testing.assert_array_equal(lo, nlo)
        np.testing.assert_array_equal(pos, npos)
        np.testing.assert_array_equal(strand, nz)


def test_merge_rung_2048_matches_native(rng):
    """At the merge stage's 2048 ladder rung (k=31, w=19, the rung's
    _batch_m slots), the on-device gather + windowed sketch that
    merge.sketch_contigs runs emits the same buffers as the native host
    twin, pad rows included."""
    from minicom_tpu import native
    from minicom_tpu.ops.sketch import (gather_contig_rows,
                                        sketch_windowed_compact32)
    from minicom_tpu.pipeline.merge import _RANK_CAP, _batch_m
    if not native.has_native():
        pytest.skip("native toolchain unavailable")
    k, w, Lmax, rows, nb = 31, 19, 2048, 96, 80
    m = _batch_m(Lmax, k, w, _RANK_CAP)
    ref = rng.integers(0, 4, 1 << 16, dtype=np.uint8)
    starts = rng.integers(0, len(ref) - Lmax, nb).astype(np.int64)
    lengths = rng.integers(513, Lmax + 1, nb).astype(np.int32)
    sl = np.zeros((2, rows), np.int32)
    sl[0] = len(ref)                      # pad rows gather out of range
    sl[0, :nb], sl[1, :nb] = starts, lengths
    codes, ln = gather_contig_rows(jnp.asarray(ref), jnp.asarray(sl), Lmax)
    buf = np.asarray(sketch_windowed_compact32(codes, ln, k, w, m))
    cm = rows * m
    xk = buf[:cm].reshape(rows, m)
    xm = buf[cm:2 * cm].view(np.int32).reshape(rows, m)
    xnv = buf[2 * cm:].view(np.int32)
    assert (xnv[nb:] == 0).all()
    nk, nm, nnv = native.sketch_windowed_host(
        ref, starts, lengths, k, np.full(nb, w, np.int32),
        np.full(nb, m, np.int32), m)
    np.testing.assert_array_equal(xnv[:nb], nnv)
    v = np.arange(m)[None, :] < nnv[:, None]
    np.testing.assert_array_equal(xk[:nb][v], nk[v])
    np.testing.assert_array_equal(xm[:nb][v], nm[v])

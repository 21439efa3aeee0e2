"""Minimizer sketch kernels (reference: sketch.c) — 32-bit device design.

Reimplements the two live sketch functions of the reference as vectorized
fixed-shape JAX ops:

* :func:`sketch_reads` — whole-read canonical minimizer (`mm_sketch_two`,
  sketch.c:238-289): one (hash, kmer, end_pos, strand) record per read.
* :func:`sketch_windowed` — (w,k)-minimizer scan with tie emission
  (`mm_sketch_lh_ori`, sketch.c:116-165) used on contig sequences; returns the
  first ``m`` minimizers per sequence in position order.

Representation: the reference rolls 64-bit k-mers and ranks them by an
invertible 64-bit mix (`hash64`, sketch.c:27-37). Device code here is 32-bit
by convention (JAX needs the global jax_enable_x64 switch for 64-bit
integers), so a k-mer (2k <= 62 bits) lives as an (hi, lo) uint32 pair — each 2-bit base field
sits at an even bit offset and therefore never straddles the 32-bit boundary,
making the pair build k static OR-shifts per word. Minimizer RANKING uses a
murmur3-style 32-bit avalanche of the pair; cluster GROUPING uses the exact
canonical k-mer value (reassembled to uint64 on the host, where it is native),
so hash width affects only which k-mer is selected, never correctness.
K-mers are formed by k shifted ORs over the whole [N, L] code matrix — no
sequential scan; window minima use an O(log w) sparse-table reduction.

Canonical k-mer rule (as the reference): forward vs reverse-complement,
strand = 1 iff forward >= rc; exact palindromes (possible only for even k)
are skipped.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Constants inside jitted bodies are NUMPY values on purpose: a `jnp.`
# constant is created EAGERLY on the default device at trace time and then
# fetched back during lowering (mlir ir_constant -> Array._value), a device
# round trip per constant. Host numpy constants lower straight from host
# memory.
U32_MAX = np.uint32(0xFFFFFFFF)


def mix32(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    """32-bit avalanche of a (hi, lo) k-mer pair (murmur3 finalizer core)."""
    h = (hi * np.uint32(0x9E3779B1)) ^ (lo * np.uint32(0x85EBCA77))
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def _take1(a: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """a[i, idx[i]] without materializing an arange(N) constant."""
    return jnp.take_along_axis(a, idx[:, None], axis=1)[:, 0]


def _kmer_pairs(codes: jnp.ndarray, k: int, valid_len=None):
    """All canonical k-mers of [N, L] base codes as uint32 pairs.

    Returns (h32, hi, lo, strand, valid) each [N, S]; position s is the k-mer
    START (end position = s + k - 1). Invalid = palindrome or window past
    valid_len.
    """
    N, L = codes.shape
    S = L - k + 1
    assert S >= 1, "sequence shorter than k"
    c = codes.astype(jnp.uint32)
    z = jnp.zeros_like(c[:, :S])
    f_hi, f_lo, r_hi, r_lo = z, z, z, z
    for j in range(k):
        cj = c[:, j:j + S]
        foff = 2 * (k - 1 - j)          # forward: base j at bits [foff, foff+2)
        roff = 2 * j                    # rc: complement base at bits [roff, ...)
        comp = cj ^ np.uint32(3)
        if foff >= 32:
            f_hi = f_hi | (cj << np.uint32(foff - 32))
        else:
            f_lo = f_lo | (cj << np.uint32(foff))
        if roff >= 32:
            r_hi = r_hi | (comp << np.uint32(roff - 32))
        else:
            r_lo = r_lo | (comp << np.uint32(roff))

    fwd_smaller = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo < r_lo))
    palindrome = (f_hi == r_hi) & (f_lo == r_lo)
    strand = jnp.where(fwd_smaller, 0, 1).astype(jnp.int8)
    hi = jnp.where(fwd_smaller, f_hi, r_hi)
    lo = jnp.where(fwd_smaller, f_lo, r_lo)
    h = mix32(hi, lo)

    valid = ~palindrome
    if valid_len is not None:
        pos = np.arange(S, dtype=np.int32)[None, :]
        valid = valid & (pos + k <= valid_len[:, None])
    h = jnp.where(valid, h, U32_MAX)
    return h, hi, lo, strand, valid


@functools.partial(jax.jit, static_argnames=("k_max",))
def sketch_reads_dyn_gather(codes_all: jnp.ndarray, rids: jnp.ndarray, k,
                            k_max: int = 31):
    """sketch_reads_dyn over rows gathered from the device-resident read
    store: upload cost is 4 bytes/read (the rid) instead of L bytes."""
    return _sketch_dyn_body(codes_all[rids], k, k_max)


@functools.partial(jax.jit, static_argnames=("k_max",))
def sketch_reads_dyn_gather_packed(codes_all: jnp.ndarray, rids: jnp.ndarray,
                                   k, k_max: int = 31):
    """sketch_reads_dyn_gather with ONE packed output [3, N] uint32:
    (kmer_hi, kmer_lo, end_pos << 1 | strand): one device->host copy per
    batch instead of five; the h32 ranking hash never leaves the device."""
    h, hi, lo, pos, strand = _sketch_dyn_body(codes_all[rids], k, k_max)
    meta = ((pos.astype(jnp.uint32) << np.uint32(1))
            | strand.astype(jnp.uint32))
    return jnp.stack([hi, lo, meta])


@functools.partial(jax.jit, static_argnames=("k_max",))
def sketch_reads_dyn(codes: jnp.ndarray, k, k_max: int = 31):
    """Whole-read canonical minimizer with k as a TRACED scalar.

    One XLA program serves every k in [2, k_max] — the k-decreasing cluster
    rounds (kt_for_bucket's kmer = K - round, kthread_bucket.c:592) reuse a
    single compile instead of one per round. K-mers are accumulated from the
    END position: forward base j-back contributes at static bit offset 2j,
    reverse-complement at dynamic offset 2(k-1-j) (a traced-scalar shift),
    each masked by j < k.

    Returns (h32, kmer_hi, kmer_lo, end_pos, strand), like sketch_reads.
    """
    return _sketch_dyn_body(codes, k, k_max)


def _sketch_dyn_body(codes: jnp.ndarray, k, k_max: int):
    N, L = codes.shape
    k = jnp.asarray(k, jnp.uint32)
    c = codes.astype(jnp.uint32)
    z32 = jnp.zeros_like(c)
    f_hi, f_lo, r_hi, r_lo = z32, z32, z32, z32
    # Forward k-mers have STATIC bit offsets when indexed from the k-mer END
    # (base j-back sits at bits 2j); reverse-complement k-mers have static
    # offsets when indexed from the START (complement of base j-forward at
    # bits 2j). A single traced roll by k-1 aligns the start-indexed rc
    # array to end positions — no per-term dynamic shifts while k is a
    # runtime scalar.
    for j in range(k_max):
        live = j < k
        cE = jnp.pad(c, ((0, 0), (j, 0)))[:, :L] if j else c      # c[i-j]
        cS = jnp.pad(c, ((0, 0), (0, j)))[:, j:] if j else c      # c[s+j]
        fv = jnp.where(live, cE, 0)
        rv = jnp.where(live, cS ^ np.uint32(3), 0)
        if 2 * j >= 32:
            f_hi = f_hi | (fv << np.uint32(2 * j - 32))
            r_hi = r_hi | (rv << np.uint32(2 * j - 32))
        else:
            f_lo = f_lo | (fv << np.uint32(2 * j))
            r_lo = r_lo | (rv << np.uint32(2 * j))
    # rc of the k-mer ending at i lives at start index i-(k-1): roll right
    r_hi = jnp.roll(r_hi, k - 1, axis=1)
    r_lo = jnp.roll(r_lo, k - 1, axis=1)

    fwd_smaller = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo < r_lo))
    palindrome = (f_hi == r_hi) & (f_lo == r_lo)
    strand = jnp.where(fwd_smaller, 0, 1).astype(jnp.int8)
    hi = jnp.where(fwd_smaller, f_hi, r_hi)
    lo = jnp.where(fwd_smaller, f_lo, r_lo)
    h = mix32(hi, lo)
    pos_i = np.arange(L, dtype=np.uint32)[None, :]
    valid = ~palindrome & (pos_i + 1 >= k)
    h = jnp.where(valid, h, U32_MAX)
    s = jnp.argmin(h, axis=1)
    # a read with NO valid k-mer (every k-mer palindromic — possible only at
    # even k) gets the canonical empty record (U32_MAX, 0, 0, 0, 0) instead
    # of whatever padded partial k-mer argmin landed on: well-defined, and
    # exactly reproducible by the native host twin (sketch.cpp)
    hm = _take1(h, s)
    bad = hm == U32_MAX
    z32 = jnp.zeros_like(hm)
    return (hm, jnp.where(bad, z32, _take1(hi, s)),
            jnp.where(bad, z32, _take1(lo, s)),
            jnp.where(bad, 0, s).astype(jnp.int32),
            jnp.where(bad, 0, _take1(strand, s)).astype(jnp.int8))


@functools.partial(jax.jit, static_argnames=("k",))
def sketch_reads(codes: jnp.ndarray, k: int):
    """Whole-read canonical minimizer per read (mm_sketch_two semantics).

    codes: [N, L] uint8 with no ambiguity codes (N already substituted,
    kthread_reads.c:182-205). Returns (h32 [N] u32, kmer_hi [N] u32,
    kmer_lo [N] u32, end_pos [N] int32, strand [N] int8). First position wins
    hash ties (the reference's strict-< update). A read with no valid k-mer
    gets the canonical empty record (U32_MAX, 0, 0, 0, 0).
    """
    h, hi, lo, strand, _valid = _kmer_pairs(codes, k)
    s = jnp.argmin(h, axis=1)
    hm = _take1(h, s)
    bad = hm == U32_MAX
    z32 = jnp.zeros_like(hm)
    return (hm, jnp.where(bad, z32, _take1(hi, s)),
            jnp.where(bad, z32, _take1(lo, s)),
            jnp.where(bad, 0, s + k - 1).astype(jnp.int32),
            jnp.where(bad, 0, _take1(strand, s)).astype(jnp.int8))


def _sliding_reduce(x: jnp.ndarray, w: int, op) -> jnp.ndarray:
    """op-reduction over each length-w window along axis 1 (sparse table)."""
    S = x.shape[1]
    f = x
    span = 1
    while span * 2 <= w:
        f = op(f[:, : S - span], f[:, span:])
        S = S - span
        span *= 2
    rem = w - span
    if rem:
        out = op(f[:, : x.shape[1] - w + 1], f[:, rem: rem + x.shape[1] - w + 1])
    else:
        out = f[:, : x.shape[1] - w + 1]
    return out


@functools.partial(jax.jit, static_argnames=("Lmax",))
def gather_contig_rows(ref_flat: jnp.ndarray, sl: jnp.ndarray, Lmax: int):
    """[2, rows] int32 (start, length) -> ([rows, Lmax] uint8, [rows] int32).

    The merge stage splits its sketch into this cheap gather (whose shape
    depends on the padded contig-stream length) and the windowed sketch
    (whose shape depends only on the fixed row tile), so each sketch program
    is compiled once per (config, ladder rung) whatever the dataset."""
    idx = sl[0][:, None] + np.arange(Lmax, dtype=np.int32)[None, :]
    return ref_flat.at[idx].get(mode="fill", fill_value=0), sl[1]


@functools.partial(jax.jit, static_argnames=("k", "w", "m"))
def sketch_windowed_compact32(codes: jnp.ndarray, lengths: jnp.ndarray,
                              k: int, w: int, m: int):
    """sketch_windowed over pre-gathered rows with the transfer-minimal
    output buffer: one flat uint32 array laid out as rows*m 32-bit-hashed
    keys (mix32 of the 64-bit canonical k-mer), then rows*m packed meta
    words (pos<<1 | strand), then rows valid-counts nv. Hashed 32-bit keys
    are safe as grouping keys because every candidate pair is re-verified
    against the real bases."""
    h, hi, lo, pos, strand, valid = _sketch_windowed_body(
        codes, lengths, k, w, m)
    meta = (pos << 1) | strand.astype(jnp.int32)
    nv = valid.sum(axis=1, dtype=jnp.int32)
    return jnp.concatenate([
        mix32(hi, lo).reshape(-1),
        jax.lax.bitcast_convert_type(meta.reshape(-1), jnp.uint32),
        jax.lax.bitcast_convert_type(nv, jnp.uint32)])


@functools.partial(jax.jit, static_argnames=("k", "w", "m"))
def sketch_windowed(codes: jnp.ndarray, lengths: jnp.ndarray, k: int, w: int, m: int):
    """(w,k)-minimizers with tie emission, first ``m`` per sequence.

    codes: [C, Lmax] uint8 (rows padded arbitrarily beyond ``lengths``).
    Window semantics (canonical, padding-independent): windows of length
    min(w, S) start at every k-mer position and are CLIPPED at the row's end —
    the trailing partial windows reproduce the reference's final-min push
    (sketch.c:163-164) uniformly. Position i is emitted iff its hash equals
    the minimum of at least one window covering i (including equal-hash ties
    within a window, sketch.c:139-159).

    Returns (h32, kmer_hi, kmer_lo, end_pos, strand, valid), each [C, m],
    ordered by position.
    """
    return _sketch_windowed_body(codes, lengths, k, w, m)


def _sketch_windowed_body(codes: jnp.ndarray, lengths: jnp.ndarray,
                          k: int, w: int, m: int):
    C, Lmax = codes.shape
    S = Lmax - k + 1
    h, khi, klo, strand, _ = _kmer_pairs(codes, k, valid_len=lengths)

    we = min(w, S)
    hp = jnp.pad(h, ((0, 0), (0, we - 1)), constant_values=U32_MAX)
    W = _sliding_reduce(hp, we, jnp.minimum)            # [C, S]
    padded = jnp.pad(W, ((0, 0), (we - 1, 0)), constant_values=U32_MAX)
    Wmax = _sliding_reduce(
        jnp.where(padded == U32_MAX, np.uint32(0), padded), we, jnp.maximum)
    emitted = (Wmax == h) & (h != U32_MAX)

    # first-m selection in position order
    order = jnp.cumsum(emitted.astype(jnp.int32), axis=1)
    keep = emitted & (order <= m)
    slot = jnp.where(keep, order - 1, m)
    rows = jax.lax.broadcasted_iota(jnp.int32, order.shape, 0)
    pos = jax.lax.broadcasted_iota(jnp.int32, order.shape, 1)
    def dump(vals, fill, dtype):
        out = jnp.full_like(h, fill, shape=(C, m + 1), dtype=dtype)
        return out.at[rows, slot].set(vals, mode="drop")[:, :m]
    out_h = dump(h, U32_MAX, jnp.uint32)
    out_hi = dump(khi, 0, jnp.uint32)
    out_lo = dump(klo, 0, jnp.uint32)
    out_p = dump(pos, 0, jnp.int32)
    out_z = dump(strand, 0, jnp.int8)
    nvalid = jnp.minimum(order[:, -1], m)
    valid = np.arange(m, dtype=np.int32)[None, :] < nvalid[:, None]
    return out_h, out_hi, out_lo, out_p + (k - 1), out_z, valid

"""On-chip interleaved rANS entropy codec (SURVEY.md §7 step 8: the C23
equivalent that runs on the device instead of shelling out to bsc,
/root/reference/install.sh:3-15, minicom:115-148).

Order-0 static-table rANS over uint8 symbols, vectorized across LANES
independent coder states (lane l owns symbols l, l+LANES, l+2*LANES, ...),
so every scan step encodes/decodes LANES symbols as one fused VPU step:

* 32-bit states in [2^16, 2^32), 16-bit renormalization — at most one
  16-bit word emitted (encode) or consumed (decode) per lane per step,
* frequencies quantized to M = 2^12 by deterministic largest-remainder
  rounding; the quantized table ships in the block header so decode needs
  no float math and archives stay bit-reproducible,
* encode runs the symbol scan in reverse (the rANS stack discipline),
  emissions are compacted on device by per-lane prefix-sum scatter; decode
  replays forward with per-lane stream cursors (one gather per step).

The container's host codecs (o1rc/o2rc/dnarc, entropy/backend.py) stay the
default; this kernel is the device path (`--codec device`), parity-tested
in tests/test_entropy.py. LANES is part of the stream format. Codec name:
"trans" (also "pK:trans" through the byte-plane transform in
entropy/backend.py).

Stream layout (host-assembled, little-endian), per block:
  u8  version (=1)       u8 log2(LANES)       u16 M (=4096)
  u64 n_symbols
  u16 freq[256]          (quantized; absent symbols 0)
  u32 state[LANES]       (encoder final = decoder initial states)
  u32 words_per_lane[LANES]
  u16 lane streams, concatenated in lane order (decode read order)
"""

from __future__ import annotations

import functools

import numpy as np

LANES = 128
M_BITS = 12
M = 1 << M_BITS
RANS_L = 1 << 16          # state lower bound; renorm moves 16 bits
_VERSION = 1
# symbols per block: full blocks share one compiled program shape; tail
# blocks round T up to a pow2 tier so the program cache stays tiny
BLOCK = 1 << 20


def quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """Deterministic largest-remainder quantization of a 256-bin histogram
    to sum exactly M, every present symbol >= 1."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        q = np.zeros(256, np.int64)
        q[0] = M
        return q.astype(np.uint16)
    scaled = counts * M / total
    q = np.floor(scaled).astype(np.int64)
    q[(counts > 0) & (q == 0)] = 1
    diff = M - int(q.sum())
    if diff > 0:
        # hand the deficit to the largest remainders (ties: lower symbol)
        rem = scaled - np.floor(scaled)
        rem[counts == 0] = -1.0
        order = np.lexsort((np.arange(256), -rem))
        q[order[:diff]] += 1
    else:
        # take the surplus from the largest entries that stay >= 1
        for _ in range(-diff):
            cand = np.flatnonzero(q > 1)
            q[cand[np.argmax(q[cand])]] -= 1
    assert q.sum() == M
    return q.astype(np.uint16)


@functools.lru_cache(maxsize=16)
def _encode_program(T: int):
    import jax
    import jax.numpy as jnp

    def step(x, fcv):
        f, c, valid = fcv           # [LANES] uint32, uint32, bool
        # emit condition x >= f << 20 written shift-right to avoid uint32
        # overflow at f == M (the all-one-symbol block: never emits)
        emit = ((x >> jnp.uint32(20)) >= f) & valid
        word = jnp.where(emit, x & jnp.uint32(0xFFFF), jnp.uint32(0)
                         ).astype(jnp.uint16)
        xr = jnp.where(emit, x >> jnp.uint32(16), x)
        xn = ((xr // f) << jnp.uint32(M_BITS)) | ((xr % f) + c)
        # pad steps (beyond the stream tail) pass the state through: they
        # cost zero bits and the decoder skips them symmetrically
        return jnp.where(valid, xn, x), (emit, word)

    def encode(syms, valid, freq, cum):
        """syms [T, LANES] uint8 in FORWARD time order (+ validity mask for
        the tail pad) -> (final states, per-lane word columns compacted into
        [T, LANES] rows 0.. in decode read order, per-lane word counts)."""
        f = freq[syms.astype(jnp.int32)]       # [T, LANES] uint32
        # pad slots may carry symbol 0 with freq 0 (absent from the real
        # data); their results are discarded but the division must not be /0
        f = jnp.maximum(f, jnp.uint32(1))
        c = cum[syms.astype(jnp.int32)]
        x0 = jnp.full((LANES,), RANS_L, jnp.uint32)
        # reverse scan = process symbol T-1 first; stacked outputs stay
        # aligned to their input row, i.e. already in forward time order,
        # which IS the decoder's read order
        x, (emit, word) = jax.lax.scan(step, x0, (f, c, valid), reverse=True)
        counts = emit.sum(axis=0, dtype=jnp.int32)              # [LANES]
        pos = jnp.cumsum(emit.astype(jnp.int32), axis=0) - 1    # [T, LANES]
        pos = jnp.where(emit, pos, T)                           # park drops
        lane = jnp.broadcast_to(jnp.arange(LANES, dtype=jnp.int32),
                                pos.shape)
        out = jnp.zeros((T + 1, LANES), jnp.uint16)
        out = out.at[pos, lane].set(word)
        return x, out[:T], counts

    return jax.jit(encode)


@functools.lru_cache(maxsize=16)
def _decode_program(T: int):
    import jax
    import jax.numpy as jnp

    def decode(states, words, valid, freq, cum, slot_sym):
        """states [LANES] u32, words [W, LANES] u16 (read order), validity
        mask [T, LANES] (mirrors encode's tail pad), tables; returns
        symbols [T, LANES] in forward time order."""
        W = words.shape[0]
        lanes_iota = jnp.arange(LANES)

        def step(carry, v):
            x, ptr = carry
            slot = x & jnp.uint32(M - 1)
            s = slot_sym[slot].astype(jnp.int32)          # [LANES]
            f = freq[s]
            c = cum[s]
            xn = f * (x >> jnp.uint32(M_BITS)) + slot - c
            need = (xn < jnp.uint32(RANS_L)) & v
            nxt = words[jnp.minimum(ptr, W - 1), lanes_iota
                        ].astype(jnp.uint32)
            xn = jnp.where(need, (xn << jnp.uint32(16)) | nxt, xn)
            ptr = ptr + need.astype(jnp.int32)
            return (jnp.where(v, xn, x), ptr), s.astype(jnp.uint8)

        ptr0 = jnp.zeros((LANES,), jnp.int32)
        (_, _), syms = jax.lax.scan(step, (states, ptr0), valid, length=T)
        return syms

    return jax.jit(decode)


def _tables(freq_q: np.ndarray):
    import jax.numpy as jnp
    cum = np.concatenate([[0], np.cumsum(freq_q[:-1], dtype=np.int64)])
    slot_sym = np.repeat(np.arange(256, dtype=np.uint8),
                         freq_q.astype(np.int64))
    assert len(slot_sym) == M
    return (jnp.asarray(freq_q.astype(np.uint32)),
            jnp.asarray(cum.astype(np.uint32)), jnp.asarray(slot_sym))


def _tier(T: int) -> int:
    """Round a tail-block step count up to a pow2 tier (>=256) so compiled
    program shapes are dataset-independent."""
    full = BLOCK // LANES
    if T >= full:
        return full
    t = 256
    while t < T:
        t <<= 1
    return t


def _wtier(W: int) -> int:
    """Round the per-lane word-matrix height up to a pow2 tier (>=64) so the
    decode program shape is dataset-independent too — without this, W varies
    with the max per-lane emission count of every block and jax.jit retraces
    per block (ADVICE r04). Zero-padding is safe: decode reads
    words[min(ptr, W-1)] and the validity mask stops every lane at its own
    word count."""
    t = 64
    while t < W:
        t <<= 1
    return t


def _encode_block(syms: np.ndarray) -> bytes:
    """One rANS block over <= BLOCK uint8 symbols."""
    import jax.numpy as jnp
    n = len(syms)
    T = _tier(max(1, -(-n // LANES)))
    pad = T * LANES - n
    counts = np.bincount(syms, minlength=256)
    if pad:
        syms = np.concatenate([syms, np.zeros(pad, np.uint8)])
    freq_q = quantize_freqs(counts)
    freq_d, cum_d, _ = _tables(freq_q)
    import time as _time
    from minicom_tpu.parallel import mesh as _mesh
    t0 = _time.perf_counter()
    grid = jnp.asarray(syms.reshape(T, LANES))
    valid = jnp.asarray((np.arange(T * LANES) < n).reshape(T, LANES))
    states, words, wcounts = _encode_program(T)(grid, valid, freq_d, cum_d)
    states = np.asarray(states)
    words = np.asarray(words)
    wcounts = np.asarray(wcounts)
    _mesh._account(_time.perf_counter() - t0,
                   grid.nbytes + grid.size + words.nbytes + states.nbytes)
    head = (bytes([_VERSION, LANES.bit_length() - 1])
            + np.array([M], "<u2").tobytes()
            + np.array([n], "<u8").tobytes()
            + freq_q.astype("<u2").tobytes()
            + states.astype("<u4").tobytes()
            + wcounts.astype("<u4").tobytes())
    lanes_bytes = b"".join(
        words[: wcounts[l], l].astype("<u2").tobytes()
        for l in range(LANES))
    return head + lanes_bytes


def _decode_block(blob: bytes | memoryview) -> tuple[np.ndarray, int]:
    """Returns (symbols, bytes consumed)."""
    import jax.numpy as jnp
    blob = memoryview(blob)
    if blob[0] != _VERSION or (1 << blob[1]) != LANES:
        raise ValueError("trans stream: bad block header "
                         f"(version {blob[0]}, lanes 2^{blob[1]})")
    off = 2
    m = int(np.frombuffer(blob, "<u2", 1, off)[0]); off += 2
    if m != M:
        raise ValueError(f"trans stream: table size {m} != {M}")
    n = int(np.frombuffer(blob, "<u8", 1, off)[0]); off += 8
    freq_q = np.frombuffer(blob, "<u2", 256, off).copy(); off += 512
    states = np.frombuffer(blob, "<u4", LANES, off).copy(); off += 4 * LANES
    wcounts = np.frombuffer(blob, "<u4", LANES, off).astype(np.int64)
    off += 4 * LANES
    total_words = int(wcounts.sum())
    flat = np.frombuffer(blob, "<u2", total_words, off)
    off += 2 * total_words
    T = _tier(max(1, -(-n // LANES)))
    W = _wtier(max(1, int(wcounts.max())))
    words = np.zeros((W, LANES), np.uint16)
    starts = np.concatenate([[0], np.cumsum(wcounts)])
    for l in range(LANES):
        words[: wcounts[l], l] = flat[starts[l]: starts[l + 1]]
    freq_d, cum_d, slot_d = _tables(freq_q)
    import time as _time
    from minicom_tpu.parallel import mesh as _mesh
    t0 = _time.perf_counter()
    valid = jnp.asarray((np.arange(T * LANES) < n).reshape(T, LANES))
    syms = _decode_program(T)(jnp.asarray(states.astype(np.uint32)),
                              jnp.asarray(words), valid,
                              freq_d, cum_d, slot_d)
    out = np.asarray(syms)
    _mesh._account(_time.perf_counter() - t0,
                   words.nbytes + valid.size + out.nbytes)
    return out.reshape(-1)[:n], off


def compress(data: bytes) -> bytes:
    """Codec entry: uint8 stream -> framed rANS blocks."""
    syms = np.frombuffer(data, np.uint8)
    parts = [np.array([len(syms)], "<u8").tobytes()]
    for i in range(0, len(syms), BLOCK):
        parts.append(_encode_block(syms[i: i + BLOCK]))
    return b"".join(parts)


def decompress(blob: bytes) -> bytes:
    n = int(np.frombuffer(blob, "<u8", 1)[0])
    off = 8
    out = []
    got = 0
    while got < n:
        syms, used = _decode_block(memoryview(blob)[off:])
        out.append(syms)
        got += len(syms)
        off += used
    if got != n:
        raise ValueError(
            f"trans stream: decoded {got} symbols, header says {n}")
    return b"".join(s.tobytes() for s in out)

"""Pluggable entropy backends (reference: external bsc/7z, C23 in SURVEY.md).

The reference shells out to `bsc e -b64p -e2` per stream and `7z` for one PE
stream (`minicom:115-148,247`). Here each stream is entropy-coded in-process
through a named backend:

* "xz"    — LZMA raw stream (host, stdlib),
* "o1rc"  — native order-1 adaptive binary range coder,
* "o2rc"  — native order-2 (two previous bytes) range coder,
* "dnarc" — native 2-bit base-symbol coder with a 16-base rolling-hash
            context (for the packed consensus / singleton streams: repeated
            genome regions across contigs predict the next base — the
            redundancy the reference outsources to bsc's BWT),
* "dz"    — native base-level LZ front end + BLOCKED dnarc literals: the
            cross-contig repeats become copy tokens (decoded at memcpy
            speed) so the literal entropy stage parallelizes — the decode-
            side answer to dnarc's serial one-big-model pass (r05),
* "trans" — ON-CHIP interleaved rANS (entropy/device_rans.py): order-0
            static-table coder as a 128-lane lax.scan program; the
            device entropy path (SURVEY §7 step 8),
* "trans1"/"trans2" — ON-CHIP context-modeled rANS (device_ctx_rans.py):
            static per-block tables over the used-byte alphabet conditioned
            on the previous 1/2 symbols, chunked lanes so contexts are true
            sequential windows; beats host o2rc on the diff streams (r05),
* "bz2" / "zlib" / "store" — stdlib alternatives.

Any codec may be prefixed "pK:" (K in 2,4,8): the stream is treated as an
array of K-byte little-endian records and deinterleaved into K byte planes
before coding (delta-position / count / id streams compress better by
plane). The transform is exactly invertible given the stream length.

Streams are independent, so archives remain deterministic and
host/device-count independent.
"""

from __future__ import annotations

import bz2
import lzma
import zlib

import numpy as np

# -9e with the dictionary capped at 8 MiB: the container only trial-encodes
# streams <= 512 KiB with xz (io/container.py _TRIAL_MAX), where a 64 MiB
# dictionary buys nothing but ~700 MB of encoder RSS per pool worker — at
# 1M-read scale that fixed allocation DOMINATED per-rank peak RSS and masked
# the sharded store's memory scaling (SCALING r05). Decode uses the same
# explicit filter chain, so archives stay self-consistent.
_XZ_FILTERS = [{"id": lzma.FILTER_LZMA2, "preset": 9 | lzma.PRESET_EXTREME,
                "dict_size": 1 << 23}]

_RC_FAMILIES = ("o1rc", "o2rc", "dnarc", "dz")


def _split(name: str) -> tuple[int, str]:
    if name.startswith("p") and ":" in name:
        stride, base = name.split(":", 1)
        return int(stride[1:]), base
    return 1, name


def _deinterleave(data: bytes, stride: int) -> bytes:
    if stride == 1 or len(data) % stride:
        return data
    a = np.frombuffer(data, np.uint8).reshape(-1, stride)
    return a.T.tobytes()


def _interleave(data: bytes, stride: int) -> bytes:
    if stride == 1 or len(data) % stride:
        return data
    a = np.frombuffer(data, np.uint8).reshape(stride, -1)
    return a.T.tobytes()


def compress(name: str, data: bytes) -> bytes:
    stride, base = _split(name)
    data = _deinterleave(data, stride)
    if base == "store":
        return data
    if base == "xz":
        return lzma.compress(data, format=lzma.FORMAT_RAW, filters=_XZ_FILTERS)
    if base == "bz2":
        return bz2.compress(data, 9)
    if base == "zlib":
        return zlib.compress(data, 9)
    if base == "dz":
        from minicom_tpu import native
        return native.dz_encode(data)
    if base in _RC_FAMILIES:
        from minicom_tpu import native
        return native.rc_encode(base, data)
    if base == "trans":
        from minicom_tpu.entropy import device_rans
        return device_rans.compress(data)
    if base in ("trans1", "trans2"):
        from minicom_tpu.entropy import device_ctx_rans
        return device_ctx_rans.compress(data, k=int(base[-1]))
    if base == "dzt":
        from minicom_tpu.entropy import device_ctx_rans
        return device_ctx_rans.compress_dz(data)
    raise ValueError(f"unknown codec {name!r}")


def decompress(name: str, data: bytes, raw_len: int) -> bytes:
    stride, base = _split(name)
    if base == "store":
        out = data
    elif base == "xz":
        out = lzma.decompress(data, format=lzma.FORMAT_RAW, filters=_XZ_FILTERS)
    elif base == "bz2":
        out = bz2.decompress(data)
    elif base == "zlib":
        out = zlib.decompress(data)
    elif base == "dz":
        from minicom_tpu import native
        out = native.dz_decode(data, raw_len)
    elif base in _RC_FAMILIES:
        from minicom_tpu import native
        out = native.rc_decode(base, data, raw_len)
    elif base == "trans":
        from minicom_tpu.entropy import device_rans
        out = device_rans.decompress(data)
    elif base in ("trans1", "trans2"):
        from minicom_tpu.entropy import device_ctx_rans
        out = device_ctx_rans.decompress(data)
    elif base == "dzt":
        from minicom_tpu.entropy import device_ctx_rans
        out = device_ctx_rans.decompress_dz(data)
    else:
        raise ValueError(f"unknown codec {name!r}")
    return _interleave(out, stride)


def available(name: str) -> bool:
    """Whether a codec can run in this environment (native lib may be
    missing for the range-coder family; everything else is stdlib)."""
    if _split(name)[1] in _RC_FAMILIES + ("dzt",):
        from minicom_tpu import native
        return native.has_native()
    return True


def best_of(candidates: list[str], data: bytes) -> tuple[str, bytes]:
    """Pick the smallest encoding among the AVAILABLE candidate backends
    (deterministic given the same availability; archives self-describe the
    codec used per stream)."""
    best = None
    for name in candidates:
        if not available(name):
            continue
        blob = compress(name, data)
        if best is None or len(blob) < len(best[1]):
            best = (name, blob)
    if best is None:
        raise RuntimeError("no entropy backend available")
    return best

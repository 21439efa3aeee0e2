"""Segmented majority-vote consensus kernels.

Replaces the reference's per-cluster positional count tables
(`construct_ref`, kthread_bucket.c:69-377; `construct_ref2`,
kthread_cb.c:105-218) with ONE scatter-add over a flat column space shared by
all clusters in a batch: member read m of cluster c contributes a one-hot
count at global column ``col_base[c] + offset[m] + j`` for each base j.
Consensus = argmax over the 4 base counts (ties -> lowest code, matching the
reference's strict-> update which keeps the first maximum).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def orient(codes: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
    """[M, L] codes, [M] strand -> reverse-complemented rows where strand==1."""
    rc = jnp.flip(jnp.where(codes < 4, 3 - codes, codes), axis=1)
    return jnp.where((dirs == 1)[:, None], rc, codes).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("total_cols",))
def segmented_consensus(member_base: jnp.ndarray, offsets: jnp.ndarray,
                        codes: jnp.ndarray, total_cols: int):
    """Majority-vote consensus over flat columns + per-member mismatch counts.

    member_base: [M] int32 — col_base of the member's cluster (>= total_cols
        for padding members: their scatters drop and their diffs are garbage).
    offsets: [M] int32 — member alignment offset within its cluster.
    codes:   [M, L] uint8 oriented base codes (0..3).

    Returns (consensus [total_cols] uint8, coverage [total_cols] int32,
    diffs [M] int32).
    """
    M, L = codes.shape
    cols = (member_base + offsets)[:, None] + np.arange(L, dtype=np.int32)[None, :]
    table = jnp.zeros_like(cols, shape=(total_cols, 4))
    table = table.at[cols, codes.astype(jnp.int32)].add(1, mode="drop")
    consensus = jnp.argmax(table, axis=1).astype(jnp.uint8)
    coverage = table.sum(axis=1)
    ref_at = consensus.at[cols].get(mode="fill", fill_value=255)
    diffs = (ref_at != codes).sum(axis=1, dtype=jnp.int32)
    return consensus, coverage, diffs


@functools.partial(jax.jit, donate_argnums=(0,))
def scatter_counts(table: jnp.ndarray, member_base: jnp.ndarray,
                   offsets: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """Accumulate one member chunk's one-hot base counts into the donated
    [Tp, 4] table (padding members carry base >= Tp and drop)."""
    L = codes.shape[1]
    cols = (member_base + offsets)[:, None] + np.arange(L, dtype=np.int32)[None, :]
    return table.at[cols, codes.astype(jnp.int32)].add(1, mode="drop")


@functools.partial(jax.jit, donate_argnums=(0,))
def scatter_counts_rid(table: jnp.ndarray, codes_all: jnp.ndarray,
                       rid: jnp.ndarray, dirs: jnp.ndarray,
                       member_base: jnp.ndarray,
                       offsets: jnp.ndarray) -> jnp.ndarray:
    """scatter_counts over the DEVICE-RESIDENT read store: members are
    (rid, dir) references into codes_all [N, L]; the gather + orientation
    happens on device, so per-member host->device traffic is 13 bytes
    instead of L+13."""
    L = codes_all.shape[1]
    codes = orient(codes_all[rid], dirs)
    cols = (member_base + offsets)[:, None] + np.arange(L, dtype=np.int32)[None, :]
    return table.at[cols, codes.astype(jnp.int32)].add(1, mode="drop")


@jax.jit
def member_diffs_packed_rid(packed: jnp.ndarray, codes_all: jnp.ndarray,
                            rid: jnp.ndarray, dirs: jnp.ndarray,
                            member_base: jnp.ndarray,
                            offsets: jnp.ndarray) -> jnp.ndarray:
    """member_diffs_packed over the device-resident read store."""
    L = codes_all.shape[1]
    codes = orient(codes_all[rid], dirs).astype(jnp.uint32)
    cols = (member_base + offsets)[:, None] + np.arange(L, dtype=np.int32)[None, :]
    words = packed.at[cols >> 4].get(mode="fill", fill_value=0)
    ref = (words >> ((cols & 15).astype(jnp.uint32) * 2)) & 3
    return (ref != codes).sum(axis=1).astype(jnp.int16)


# ---- packed-upload variants -------------------------------------------------
# Member chunks travel as ONE [n, 2, step] int32 upload of 8 bytes/member
# (one host->device copy instead of several): row 0 is
# rid*2+dir, row 1 the member's absolute start column (col_base + offset —
# the only way any kernel ever uses the two; padding members carry a column
# >= total_cols so their scatters drop and their diffs are garbage).

@functools.partial(jax.jit, donate_argnums=(0,))
def scatter_counts_rid_u(table: jnp.ndarray, codes_all: jnp.ndarray,
                         u: jnp.ndarray) -> jnp.ndarray:
    return scatter_counts_rid(table, codes_all, u[0] >> 1,
                              (u[0] & 1).astype(jnp.int8), u[1],
                              jnp.zeros_like(u[1]))


@jax.jit
def member_diffs_packed_rid_u(packed: jnp.ndarray, codes_all: jnp.ndarray,
                              u: jnp.ndarray) -> jnp.ndarray:
    return member_diffs_packed_rid(packed, codes_all, u[0] >> 1,
                                   (u[0] & 1).astype(jnp.int8), u[1],
                                   jnp.zeros_like(u[1]))


@functools.partial(jax.jit, static_argnames=("total_cols",))
def consensus_fused_rid_u(codes_all: jnp.ndarray, u: jnp.ndarray,
                          total_cols: int):
    return consensus_fused_rid(codes_all, u[0] >> 1,
                               (u[0] & 1).astype(jnp.int8), u[1],
                               jnp.zeros_like(u[1]), total_cols)


@jax.jit
def pack_parts(parts):
    """Concatenate heterogeneous device outputs into ONE uint32 buffer for
    a single d2h transfer. int16 arrays ride as bitcast pairs; callers
    split the host buffer by the known static sizes."""
    out = []
    for p in parts:
        if p.dtype == jnp.int16:
            out.append(jax.lax.bitcast_convert_type(
                p.reshape(-1, 2), jnp.uint32))
        elif p.dtype == jnp.uint32:
            out.append(p.reshape(-1))
        else:
            out.append(jax.lax.bitcast_convert_type(
                p.reshape(-1), jnp.uint32))
    return jnp.concatenate(out)


@jax.jit
def consensus_finalize(table: jnp.ndarray) -> jnp.ndarray:
    """[Tp, 4] counts -> 2-bit packed consensus words [Tp/16] uint32
    (argmax ties -> lowest code, the reference's strict-> rule)."""
    consensus = jnp.argmax(table, axis=1).astype(jnp.uint32)
    cw = consensus.reshape(-1, 16)
    packed = jnp.zeros_like(cw[:, 0])
    for i in range(16):
        packed = packed | (cw[:, i] << np.uint32(2 * i))
    return packed


@jax.jit
def member_diffs_packed(packed: jnp.ndarray, member_base: jnp.ndarray,
                        offsets: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """Mismatch counts of a member chunk against the packed consensus."""
    L = codes.shape[1]
    cols = (member_base + offsets)[:, None] + np.arange(L, dtype=np.int32)[None, :]
    words = packed.at[cols >> 4].get(mode="fill", fill_value=0)
    ref = (words >> ((cols & 15).astype(jnp.uint32) * 2)) & 3
    return (ref != codes.astype(jnp.uint32)).sum(axis=1).astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("total_cols",))
def segmented_consensus_packed(member_base: jnp.ndarray, offsets: jnp.ndarray,
                               codes: jnp.ndarray, total_cols: int):
    """segmented_consensus with transfer-friendly outputs: the consensus is
    2-bit packed into uint32 words on device (16 bases/word, the
    pack_2bit_words layout) and diffs are int16 — an 8x/2x cut in
    device->host bytes."""
    consensus, _cov, diffs = segmented_consensus(
        member_base, offsets, codes, total_cols)
    cw = consensus.reshape(-1, 16).astype(jnp.uint32)
    packed = jnp.zeros_like(cw[:, 0])
    for i in range(16):
        packed = packed | (cw[:, i] << np.uint32(2 * i))
    return packed, diffs.astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("total_cols",))
def consensus_fused_rid(codes_all: jnp.ndarray, rid: jnp.ndarray,
                        dirs: jnp.ndarray, member_base: jnp.ndarray,
                        offsets: jnp.ndarray, total_cols: int):
    """One-dispatch consensus for a single member block: gather + orient +
    scatter-add + packed argmax + member diffs in ONE XLA program (one
    dispatch and one fetch instead of three)."""
    L = codes_all.shape[1]
    codes = orient(codes_all[rid], dirs).astype(jnp.int32)
    cols = (member_base + offsets)[:, None] + np.arange(L, dtype=np.int32)[None, :]
    table = jnp.zeros_like(cols, shape=(total_cols, 4))
    table = table.at[cols, codes].add(1, mode="drop")
    consensus = jnp.argmax(table, axis=1).astype(jnp.uint32)
    cw = consensus.reshape(-1, 16)
    packed = jnp.zeros_like(cw[:, 0])
    for i in range(16):
        packed = packed | (cw[:, i] << np.uint32(2 * i))
    words = packed.at[cols >> 4].get(mode="fill", fill_value=0)
    ref = (words >> ((cols & 15).astype(jnp.uint32) * 2)) & 3
    diffs = (ref != codes.astype(jnp.uint32)).sum(axis=1).astype(jnp.int16)
    return packed, diffs


@functools.partial(jax.jit, static_argnames=())
def member_diffs(ref_flat: jnp.ndarray, member_base: jnp.ndarray,
                 offsets: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """Mismatch count of each member against an existing flat consensus."""
    L = codes.shape[1]
    cols = (member_base + offsets)[:, None] + np.arange(L, dtype=np.int32)[None, :]
    ref_at = ref_flat.at[cols].get(mode="fill", fill_value=255)
    return (ref_at != codes).sum(axis=1, dtype=jnp.int32)

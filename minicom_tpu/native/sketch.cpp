// Native windowed-minimizer sketch — the host twin of
// ops/sketch.py::sketch_windowed_compact32
// (reference semantics: mm_sketch_lh_ori, sketch.c:116-165).
//
// The merge stage routes contig sketching here when parallel/mesh.py's
// use_device() is false (CPU backend, no mesh) — the same dual-path pattern
// as consensus.cpp. Output is bit-identical to the device kernels (parity-tested,
// tests/test_sketch.py::test_native_windowed_matches_xla): same canonical
// k-mer rule (fwd vs rc 64-bit compare, palindromes skipped), same murmur3-
// style 32-bit ranking hash, same clipped-window tie emission, same first-m
// position-order selection — so archives never depend on which path ran.
//
// Window semantics (must mirror _sketch_windowed_body exactly): with
// effective window we, position i (0-based k-mer start, valid when
// i + k <= len and not a palindrome) is emitted iff some window
// j in [max(0, i-we+1), i] has min(h[j .. j+we-1], clipped) == h[i].
// A valid position whose ranking hash equals 0xFFFFFFFF is never emitted
// (the device path uses that value as the invalid sentinel — quirk kept).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint32_t U32_MAX = 0xFFFFFFFFu;

inline uint32_t mix32(uint32_t hi, uint32_t lo) {
    uint32_t h = (hi * 0x9E3779B1u) ^ (lo * 0x85EBCA77u);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// trailing-window extremum: out[i] = op over x[max(0, i-we+1) .. i]
// (monotonic deque, O(n)); MIN=true -> min, else max
template <bool MIN>
void trailing_ext(const uint32_t* x, int64_t n, int64_t we, uint32_t* out,
                  std::vector<int64_t>& dq) {
    dq.clear();
    dq.resize((size_t)n);
    int64_t head = 0, tail = 0;  // [head, tail) indices into dq
    for (int64_t i = 0; i < n; ++i) {
        while (tail > head &&
               (MIN ? x[dq[tail - 1]] >= x[i] : x[dq[tail - 1]] <= x[i]))
            --tail;
        dq[tail++] = i;
        if (dq[head] <= i - we) ++head;
        out[i] = x[dq[head]];
    }
}

}  // namespace

extern "C" {

// Per row r (a contig, codes at ref_flat[start[r] .. start[r]+rlen[r])):
// emit up to mcap[r] (key32, meta = end_pos<<1|strand) minimizer entries in
// position order into out_key/out_meta[r * m_max ..]; out_nv[r] =
// min(total_emitted, mcap[r]). we[r]/mcap[r] are per-row because the device
// path derives them from the row's length-ladder bucket — passing them in
// keeps the two paths bit-identical.
void sketch_windowed_host(
    const uint8_t* ref_flat, const int64_t* start, const int32_t* rlen,
    int64_t n_rows,
    int32_t k, const int32_t* we_row, const int32_t* mcap_row, int32_t m_max,
    uint32_t* out_key, int32_t* out_meta, int32_t* out_nv) {

    const uint64_t kmask =
        (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;

#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<uint32_t> h, W, Wp, Mx;
        std::vector<int64_t> dq;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
        for (int64_t r = 0; r < n_rows; ++r) {
            const uint8_t* seq = ref_flat + start[r];
            const int64_t len = rlen[r];
            const int64_t S = len - k + 1;
            out_nv[r] = 0;
            if (S <= 0) continue;
            const int64_t we = we_row[r] < S ? we_row[r] : S;
            const int32_t mcap = mcap_row[r];

            h.resize((size_t)S);
            // rolling canonical k-mers: fwd = first base most significant,
            // rc = complement, first base least significant (ops/sketch.py
            // _kmer_pairs bit layout)
            uint64_t fwd = 0, rc = 0;
            for (int64_t j = 0; j < k - 1; ++j) {
                fwd = (fwd << 2) | seq[j];
                rc |= (uint64_t)(seq[j] ^ 3u) << (2 * j);
            }
            for (int64_t s = 0; s < S; ++s) {
                const uint64_t nb = seq[s + k - 1];
                fwd = ((fwd << 2) | nb) & kmask;
                if (s) rc >>= 2;
                rc |= (nb ^ 3ULL) << (2 * (k - 1));
                if (fwd == rc) {  // palindrome: skipped (sketch.c:252)
                    h[(size_t)s] = U32_MAX;
                    continue;
                }
                const uint64_t canon = fwd < rc ? fwd : rc;
                h[(size_t)s] = mix32((uint32_t)(canon >> 32),
                                     (uint32_t)canon);
            }

            // leading-window min W[j] = min(h[j .. j+we-1], clipped) is the
            // trailing-window min of the reversed array
            W.resize((size_t)S);
            Wp.resize((size_t)S);
            for (int64_t i = 0; i < S; ++i) Wp[(size_t)i] = h[(size_t)(S - 1 - i)];
            trailing_ext<true>(Wp.data(), S, we, W.data(), dq);
            for (int64_t i = 0; i < S / 2; ++i)
                std::swap(W[(size_t)i], W[(size_t)(S - 1 - i)]);
            // device path maps window-min U32_MAX (all-invalid window) to 0
            // before the covering max — replicate
            for (int64_t i = 0; i < S; ++i)
                if (W[(size_t)i] == U32_MAX) W[(size_t)i] = 0;
            Mx.resize((size_t)S);
            trailing_ext<false>(W.data(), S, we, Mx.data(), dq);

            int32_t nv = 0;
            int64_t total = 0;
            uint32_t* okey = out_key + (size_t)r * m_max;
            int32_t* ometa = out_meta + (size_t)r * m_max;
            // second cheap rolling pass recovers the strand at emitted
            // positions without storing per-position k-mer pairs
            uint64_t f2 = 0, r2 = 0;
            for (int64_t j = 0; j < k - 1; ++j) {
                f2 = (f2 << 2) | seq[j];
                r2 |= (uint64_t)(seq[j] ^ 3u) << (2 * j);
            }
            for (int64_t s = 0; s < S; ++s) {
                const uint64_t nb = seq[s + k - 1];
                f2 = ((f2 << 2) | nb) & kmask;
                if (s) r2 >>= 2;
                r2 |= (nb ^ 3ULL) << (2 * (k - 1));
                if (h[(size_t)s] == U32_MAX ||
                    Mx[(size_t)s] != h[(size_t)s])
                    continue;
                ++total;
                if (nv < mcap) {
                    const int32_t strand = f2 < r2 ? 0 : 1;
                    okey[nv] = h[(size_t)s];
                    ometa[nv] = (int32_t)(((s + k - 1) << 1) | strand);
                    ++nv;
                }
            }
            out_nv[r] = (int32_t)(total < mcap ? total : mcap);
        }
    }
}

// Whole-read canonical minimizer — host twin of
// ops/sketch.py::sketch_reads_dyn (mm_sketch_two semantics,
// sketch.c:238-289): one (kmer_hi, kmer_lo, end_pos, strand) record per
// read, minimum of the 32-bit ranking hash over all valid (non-palindromic)
// k-mer end positions, FIRST position winning ties (strict-< update). A
// read with no valid k-mer gets the canonical empty record (0, 0, 0, 0)
// with hash U32_MAX — matching the device path bit-for-bit so the cluster
// stage can route through either without changing the archive.
void sketch_reads_host(const uint8_t* codes, int64_t L,
                       const int64_t* rids, int64_t n, int32_t k,
                       uint32_t* out_hi, uint32_t* out_lo,
                       int32_t* out_pos, int8_t* out_strand) {
    const uint64_t kmask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* seq = codes + rids[i] * L;
        uint64_t fwd = 0, rc = 0;
        uint32_t best = U32_MAX;
        uint64_t best_k = 0;
        int32_t best_pos = 0;
        int8_t best_z = 0;
        for (int64_t j = 0; j < L; ++j) {
            const uint64_t nb = seq[j];
            fwd = ((fwd << 2) | nb) & kmask;
            if (j) rc >>= 2;
            rc |= (nb ^ 3ULL) << (2 * (k - 1));
            if (j + 1 < k || fwd == rc) continue;
            const int z = fwd < rc ? 0 : 1;
            const uint64_t canon = z ? rc : fwd;
            const uint32_t h = mix32((uint32_t)(canon >> 32),
                                     (uint32_t)canon);
            if (h < best) {
                best = h;
                best_k = canon;
                best_pos = (int32_t)j;
                best_z = (int8_t)z;
            }
        }
        out_hi[i] = best == U32_MAX ? 0 : (uint32_t)(best_k >> 32);
        out_lo[i] = best == U32_MAX ? 0 : (uint32_t)best_k;
        out_pos[i] = best == U32_MAX ? 0 : best_pos;
        out_strand[i] = best == U32_MAX ? 0 : best_z;
    }
}

// Per-read 2-bit XOR popcounts vs the all-A (0b00) and all-T (0b11)
// constants, straight off the code matrix — the realign ladder's absorption
// prefilter (bbhashdict.c:127-227 semantics: bit-popcount of the packed
// read / its complement). One pass, no packing or gather intermediates.
void popcounts_at(const uint8_t* codes, int64_t L, const int64_t* rids,
                  int64_t n, int32_t* pop_a, int32_t* pop_t) {
    static const int32_t BITS[4] = {0, 1, 1, 2};
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* row = codes + rids[i] * L;
        int32_t a = 0, t = 0;
        for (int64_t j = 0; j < L; ++j) {
            a += BITS[row[j]];
            t += BITS[row[j] ^ 3];
        }
        pop_a[i] = a;
        pop_t[i] = t;
    }
}

// Merge-stage candidate join (the host twin of pipeline/merge.py::
// _candidate_pairs' searchsorted probe): index entries bucketed by key in
// array order (== stable-sorted equal-key runs), every probe walks its
// bucket's first `cap` entries (drop count returned), pairs emitted when the
// contigs differ and the strands match. Pair ORDER is irrelevant downstream
// (_dedupe_pairs lexsorts), only the SET with caps applied must match the
// numpy path — which the insertion-order buckets guarantee.
//
// Returns pairs written, or -(needed) if out_cap was too small.
int64_t probe_index_pairs(
    const uint32_t* ikey, const int64_t* icid, const int32_t* ipos,
    const int8_t* istrand, int64_t n_index,
    const uint32_t* pkey, const int64_t* pcid, const int32_t* ppos,
    const int8_t* pstrand, int64_t n_probe,
    int32_t cap, int64_t* drops,
    int64_t* out_a, int64_t* out_b, int64_t* out_d, int64_t out_cap) {

    // open addressing: key -> head index into a chained entry list that
    // preserves index-array order per key
    size_t hcap = 16;
    while (hcap < (size_t)n_index * 2 + 16) hcap <<= 1;
    const uint64_t hmask = hcap - 1;
    std::vector<int64_t> head(hcap, -1), tail(hcap, -1);
    std::vector<int64_t> nxt((size_t)n_index, -1);
    std::vector<uint32_t> hkey(hcap, 0);
    auto mixk = [](uint32_t k) {
        uint64_t x = (uint64_t)k * 0x9E3779B97F4A7C15ULL;
        return x ^ (x >> 29);
    };
    for (int64_t i = 0; i < n_index; ++i) {
        uint64_t h = mixk(ikey[i]) & hmask;
        while (head[h] != -1 && hkey[h] != ikey[i]) h = (h + 1) & hmask;
        if (head[h] == -1) {
            hkey[h] = ikey[i];
            head[h] = tail[h] = i;
        } else {
            nxt[(size_t)tail[h]] = i;
            tail[h] = i;
        }
    }

    int64_t n_out = 0, dropped = 0;
    for (int64_t p = 0; p < n_probe; ++p) {
        uint64_t h = mixk(pkey[p]) & hmask;
        while (head[h] != -1 && hkey[h] != pkey[p]) h = (h + 1) & hmask;
        int64_t e = head[h];
        if (e == -1) continue;
        int32_t walked = 0;
        for (; e != -1; e = nxt[(size_t)e]) {
            if (walked >= cap) {  // count the rest as drops
                for (; e != -1; e = nxt[(size_t)e]) ++dropped;
                break;
            }
            ++walked;
            if (pcid[p] == icid[e] || pstrand[p] != istrand[e]) continue;
            if (n_out < out_cap) {
                out_a[n_out] = pcid[p];
                out_b[n_out] = icid[e];
                out_d[n_out] = (int64_t)ppos[p] - ipos[e];
            }
            ++n_out;
        }
    }
    *drops = dropped;
    return n_out <= out_cap ? n_out : -n_out;
}

}  // extern "C"

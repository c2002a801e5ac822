"""Device ops vs the pure-Python oracle (property tests on random data).

Runs on the CPU backend (conftest forces JAX_PLATFORMS=cpu); the device
path is integer-exact, so CPU results are bit-identical to GPU results.
"""

import random
from fractions import Fraction

import numpy as np
import pytest

from topsicle_tpu.io import batch
from topsicle_tpu.kmers import telophrase_kmers
from topsicle_tpu.models import TelomereScanModel
from topsicle_tpu.oracle import (
    binseg_l2_single,
    boundary_detect,
    count_nonoverlapping,
    step1_trc,
    window_signal,
)


def _random_seq(rng, n, alphabet="ACGT", n_prob=0.0):
    s = []
    for _ in range(n):
        if n_prob and rng.random() < n_prob:
            s.append("N")
        else:
            s.append(rng.choice(alphabet))
    return "".join(s)


def _telomere_like(rng, pattern, telo_len, total, err=0.05):
    telo = (pattern * (telo_len // len(pattern) + 1))[:telo_len]
    telo = "".join(c if rng.random() > err else rng.choice("ACGT") for c in telo)
    rest = _random_seq(rng, total - len(telo))
    return telo + rest


@pytest.fixture(scope="module")
def rng():
    return random.Random(1234)


def test_step1_counts_match_oracle(rng):
    kmers = telophrase_kmers("CCCTAAA", 5)
    model = TelomereScanModel(kmers)
    seqs = [
        _telomere_like(rng, "CCCTAAA", 800, 3000),
        _telomere_like(rng, "TTTAGGG", 1200, 3000)[::-1],
        _random_seq(rng, 2500, n_prob=0.02),
        _random_seq(rng, 500),          # shorter than no_bp
        "CCCTAAA" * 500,                # pure repeat
    ]
    codes = [batch.encode_read(s) for s in seqs]
    counts = model.step1_counts(batch.ends_batch(codes, 1000))
    for i, s in enumerate(seqs):
        start = s[:1000].upper()
        end = s[-1000:][::-1].upper()
        for j, km in enumerate(kmers):
            assert counts[i, 0, j] == count_nonoverlapping(start, km), (i, km)
            assert counts[i, 1, j] == count_nonoverlapping(end, km), (i, km)


def test_step1_overlapping_selfmatch_kmers(rng):
    # k-mers with self-overlap (period < k) exercise the non-overlap
    # suppression: 'AAAA' in 'AAAAAA' matches once, not three times.
    kmers = ["AAAA", "TTTT", "ATAT"]
    model = TelomereScanModel(kmers)
    seqs = ["A" * 1000 + "G" * 500, ("AT" * 700)[:1400], _random_seq(rng, 1200, "AT")]
    codes = [batch.encode_read(s) for s in seqs]
    counts = model.step1_counts(batch.ends_batch(codes, 1000))
    for i, s in enumerate(seqs):
        for j, km in enumerate(kmers):
            assert counts[i, 0, j] == count_nonoverlapping(s[:1000].upper(), km)
            assert counts[i, 1, j] == count_nonoverlapping(s[-1000:][::-1].upper(), km)


def test_window_counts_match_oracle(rng):
    pattern = "CCCTAAA"
    kmers = telophrase_kmers(pattern, 5)
    wsize, slide = 100, 6
    model = TelomereScanModel(kmers, window_size=wsize, slide=slide)
    seqs = [
        _telomere_like(rng, pattern, 2000, 12000),
        _random_seq(rng, 9000, n_prob=0.01),
        _telomere_like(rng, pattern, 500, 6000),
    ]
    trimfirst, mlt = 100, 20000
    slices = [batch.extract_tail(batch.encode_read(s), "forward", trimfirst, mlt) for s in seqs]
    codes, lens = batch.tails_batch(slices, max(len(x) for x in slices))
    raw = model.rawcounts(codes)      # [B, K, W]
    for i, s in enumerate(seqs):
        starts, means = window_signal(s, "forward", kmers, wsize, slide, trimfirst, mlt)
        nw = batch.window_counts_for_lengths(np.array([lens[i]]), wsize, slide)[0]
        assert nw == len(starts)
        for w in range(nw):
            want_counts = [
                count_nonoverlapping(
                    s.upper()[trimfirst:min(mlt, len(s))][starts[w]: starts[w] + wsize - 1], km
                )
                for km in kmers
            ]
            got = raw[i, :, w].tolist()
            assert got == want_counts, (i, w)
            # and the or-1 floored mean agrees with the oracle signal
            floored = [c or 1 for c in want_counts]
            assert means[w] == sum(floored) / len(floored)


def test_rawcounts_lean_matches_dense(rng):
    """Clean batches route --rawcountpattern through the lean-wire
    rawcounts program (rawcounts_launch_packed, round 4); its [B, K, W]
    values must equal the dense-mask program's exactly — boundary
    parity does not imply this (the sum-strategy boundary never reads
    the per-K counts)."""
    pattern = "CCCTAAA"
    model = TelomereScanModel(telophrase_kmers(pattern, 5),
                              window_size=100, slide=6)
    seqs = [_telomere_like(rng, pattern, 1500, 10000) for _ in range(4)]
    slices = [batch.extract_tail(batch.encode_read(s), "forward", 100, 20000)
              for s in seqs]
    codes, lens = batch.tails_batch(slices, max(len(x) for x in slices))
    assert all("N" not in s for s in seqs)       # clean => lean eligible
    dense = model.rawcounts(codes)               # lens omitted => dense
    lean = model.rawcounts(codes, lens)          # clean + lens => lean
    kinds = {model.pack_scan_batch(codes)[0],
             model.pack_scan_batch(codes, lens)[0]}
    assert kinds == {"dense", "lean"}            # both programs exercised
    np.testing.assert_array_equal(lean, dense)


def _exact_best_t(y_counts, n, jump=5, min_size=2):
    """Brute-force exact rational argmax of the split gain over the
    integer signal; ties -> smallest t."""
    S = [0]
    for v in y_counts[:n]:
        S.append(S[-1] + v)
    best, best_g = None, None
    for t in range(jump, n, jump):
        if t < min_size or n - t < min_size:
            continue
        A = n * S[t] - t * S[n]
        g = Fraction(A * A, t * (n - t))
        if best_g is None or g > best_g:
            best, best_g = t, g
    return best


def test_changepoint_exact_vs_bruteforce(rng):
    from topsicle_tpu.ops import binseg_l2_device

    B, W = 16, 400
    ys = []
    ns = []
    for b in range(B):
        n = rng.randrange(10, W)
        base = [rng.randrange(1, 60) for _ in range(n)]
        # plant a level shift for half the rows
        if b % 2 == 0:
            cut = rng.randrange(5, n - 5)
            base = [v + 80 for v in base[:cut]] + base[cut:]
        base += [0] * (W - n)
        ys.append(base)
        ns.append(n)
    t, has = binseg_l2_device(np.array(ys, dtype=np.int64), np.array(ns, dtype=np.int32))
    for b in range(B):
        want = _exact_best_t(ys[b], ns[b])
        if want is None:
            assert not has[b]
        else:
            assert has[b] and int(t[b]) == want, b


def test_changepoint_ties_first_best(rng):
    from topsicle_tpu.ops import binseg_l2_device

    # constant signal: every candidate has gain 0 -> first candidate (5)
    y = np.full((1, 100), 7, dtype=np.int64)
    t, has = binseg_l2_device(y, np.array([100], dtype=np.int32))
    assert bool(has[0]) and int(t[0]) == 5


def test_changepoint_admissibility_bounds():
    from topsicle_tpu.ops import binseg_l2_device

    y = np.ones((3, 50), dtype=np.int64)
    t, has = binseg_l2_device(y, np.array([6, 7, 4], dtype=np.int32))
    # n=6: candidates {5} need t <= 4 -> none
    assert not bool(has[0])
    # n=7: t=5 <= 5 -> admissible
    assert bool(has[1]) and int(t[1]) == 5
    # n=4: none
    assert not bool(has[2])


def test_changepoint_two_limb_divisor_branch(rng):
    """W >= 131072 windows selects the _mul_limbs (2-limb D) multiplier
    (ops/changepoint.py:166) — production-reachable at maxlengthtelo
    ~ 655k with slide 1, and never executed by the small-W tests above.
    Exactness is checked against the Fraction oracle on data with a real
    level shift (A^2 needs all 4 limbs) plus a constant tie row."""
    from topsicle_tpu.ops import binseg_l2_device
    from topsicle_tpu.ops.changepoint import _mul_limbs, _mul_limbs_1

    W = 131072
    assert (W * W) // 4 > 0xFFFFFFFF  # the guard that selects _mul_limbs

    n0 = W
    cut = 77775  # not a candidate multiple of 5; nearest candidates tie-break
    y0 = np.fromiter((rng.randrange(1, 60) for _ in range(n0)), np.int64, n0)
    y0[:cut] += 80
    y1 = np.full(W, 7, np.int64)  # all-tie row -> first candidate (t=5)
    t, has = binseg_l2_device(np.stack([y0, y1]),
                              np.array([n0, W], dtype=np.int32))
    want = _exact_best_t(y0.tolist(), n0)
    assert bool(has[0]) and int(t[0]) == want
    assert bool(has[1]) and int(t[1]) == 5

    # unit cross-check: the generic 2-limb multiplier equals the 1-limb
    # specialization wherever the latter is defined (d < 2**32)
    a = np.array([(1 << 62) + 12345, -((1 << 61) + 999), 3, 0], np.int64)
    d = np.array([0xFFFFFFFF, 1, (1 << 31) + 7, 12], np.int64)
    from topsicle_tpu.ops.changepoint import _sq_limbs

    sq = _sq_limbs(np.abs(a))
    lo = _mul_limbs_1(sq, d)
    hi = _mul_limbs(sq, d)
    for i in range(5):
        np.testing.assert_array_equal(np.asarray(lo[i]), np.asarray(hi[i]))
    assert np.all(np.asarray(hi[5]) == 0)
    # and against Python bignum ground truth
    got = [sum(int(np.asarray(hi[j])[i]) << (32 * j) for j in range(6))
           for i in range(4)]
    want_vals = [int(a[i]) ** 2 * int(d[i]) for i in range(4)]
    assert got == want_vals


def test_full_read_boundary_vs_oracle(rng):
    pattern = "CCCTAAA"
    kmers = telophrase_kmers(pattern, 5)
    wsize, slide, trimfirst, mlt = 100, 6, 100, 20000
    model = TelomereScanModel(kmers, window_size=wsize, slide=slide)
    reads = []
    for i in range(12):
        telo_len = rng.randrange(300, 4000)
        total = rng.randrange(9500, 25000)
        s = _telomere_like(rng, pattern, telo_len, total)
        tail = "forward"
        if i % 3 == 1:
            s = s[::-1]
            tail = "reverse"
        reads.append((s, tail))

    slices = [
        batch.extract_tail(batch.encode_read(s), tail, trimfirst, mlt)
        for s, tail in reads
    ]
    codes, lens = batch.tails_batch(slices, max(len(x) for x in slices))
    n_windows = batch.window_counts_for_lengths(lens, wsize, slide)
    t, has = model.step2_boundary(codes, n_windows)
    for i, (s, tail) in enumerate(reads):
        want = boundary_detect(s, tail, kmers, wsize, slide, trimfirst, mlt)
        maxc = min(mlt, len(s))
        got = int(trimfirst + slide * t[i]) if has[i] else 0
        if got == 0 or got > maxc:
            got = 0
        assert got == want, i


def test_oracle_binseg_agrees_with_device_on_float_safe_data(rng):
    """Oracle (f64) and device (exact int) agree away from ties."""
    from topsicle_tpu.ops import binseg_l2_device

    K = 14
    for trial in range(20):
        n = rng.randrange(12, 300)
        y_counts = [rng.randrange(K, K * 20) for _ in range(n)]
        means = [c / K for c in y_counts]
        want = binseg_l2_single(means)
        t, has = binseg_l2_device(
            np.array([y_counts], dtype=np.int64), np.array([n], dtype=np.int32)
        )
        if want is None:
            assert not bool(has[0])
        else:
            assert bool(has[0]) and int(t[0]) == want, trial


def test_window_counts_strategies_identical(rng):
    """'offset' and 'bitmask' strategies are bit-identical."""
    import jax.numpy as jnp
    from topsicle_tpu.ops import match_positions, window_nonoverlap_counts
    from topsicle_tpu.kmers import pack_kmer_table

    kmers = telophrase_kmers("CCCTAAA", 5)
    table = jnp.asarray(pack_kmer_table(kmers))
    codes = np.array([
        [ord(c) for c in _telomere_like(rng, "CCCTAAA", 700, 3000)]
        for _ in range(4)
    ], dtype=np.uint8)
    from topsicle_tpu.kmers import encode_ascii
    enc = np.stack([encode_ascii(bytes(row)) for row in codes])
    m = match_positions(jnp.asarray(enc), table, 5)
    W = (3000 - 100) // 6 + 1
    a = window_nonoverlap_counts(m, 5, 100, 6, W, strategy="offset")
    b = window_nonoverlap_counts(m, 5, 100, 6, W, strategy="bitmask")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lean_wire_format_matches_dense(rng):
    """Lean (2-bit + lengths) and dense (2-bit + mask plane) wire formats
    produce bit-identical step-1 counts and step-2 boundaries on clean
    batches; batches with in-read N fall back to dense automatically."""
    kmers = telophrase_kmers("CCCTAAA", 5)
    model = TelomereScanModel(kmers, window_size=100, slide=6)
    no_bp = 1000
    seqs = [
        _telomere_like(rng, "CCCTAAA", 700, 2500),
        _telomere_like(rng, "TTTAGGG", 900, 2100)[::-1],
        _random_seq(rng, 1500),
        _random_seq(rng, 600),           # shorter than no_bp -> ragged
        "CCCTAAA" * 300,
    ]
    codes = [batch.encode_read(s) for s in seqs]
    ends = batch.ends_batch(codes, no_bp)
    ends_len = np.array([min(len(c), no_bp) for c in codes], np.int32)
    dense = model.step1_counts(ends)              # no lengths -> dense path
    lean = model.step1_counts(ends, ends_len)
    np.testing.assert_array_equal(dense, lean)

    tails = [batch.extract_tail(c, "forward", 100, 2000) for c in codes]
    tcodes, lens = batch.tails_batch(tails, max(len(t) for t in tails))
    nw = batch.window_counts_for_lengths(lens, 100, 6)
    t_d, h_d = model.step2_boundary(tcodes, nw)
    t_l, h_l = model.step2_boundary(tcodes, nw, lens)
    np.testing.assert_array_equal(np.asarray(t_d), np.asarray(t_l))
    np.testing.assert_array_equal(np.asarray(h_d), np.asarray(h_l))


def test_lean_dispatch_rejects_exotic_batches(rng):
    """_batch_is_clean: an N inside the valid prefix forces the dense
    path; pure suffix padding does not."""
    from topsicle_tpu.models.telomere import _batch_is_clean

    clean = np.full((2, 40), 0xFF, np.uint8)
    clean[0, :30] = np.tile([0, 1, 2, 3, 0, 1], 5)
    clean[1, :20] = 2
    assert _batch_is_clean(clean, np.array([30, 20]))
    dirty = clean.copy()
    dirty[1, 5] = 4                       # N inside the prefix
    assert not _batch_is_clean(dirty, np.array([30, 20]))

    # end-to-end: N-containing batch silently uses the dense program
    kmers = telophrase_kmers("CCCTAAA", 5)
    model = TelomereScanModel(kmers, window_size=100, slide=6)
    seq = _telomere_like(rng, "CCCTAAA", 400, 1400)
    noisy = seq[:200] + "N" + seq[201:]
    codes = [batch.encode_read(noisy)]
    tails = [batch.extract_tail(codes[0], "forward", 100, 1400)]
    tcodes, lens = batch.tails_batch(tails, len(tails[0]))
    nw = batch.window_counts_for_lengths(lens, 100, 6)
    t_d, h_d = model.step2_boundary(tcodes, nw)
    t_l, h_l = model.step2_boundary(tcodes, nw, lens)   # falls back to dense
    np.testing.assert_array_equal(np.asarray(t_d), np.asarray(t_l))
    np.testing.assert_array_equal(np.asarray(h_d), np.asarray(h_l))


def test_greedy_count_strategies_identical(rng):
    """'chunked' (production default) and 'tree' greedy counters are
    bit-identical across k values, odd lengths, and invalid bases —
    including lengths below/at/just-above one chunk (64)."""
    import jax.numpy as jnp
    from topsicle_tpu.ops import (greedy_count_chunked, greedy_count_full,
                                  match_positions)
    from topsicle_tpu.kmers import pack_kmer_table, encode_ascii

    for k, L in [(5, 37), (5, 64), (5, 65), (3, 200), (8, 999), (5, 1000)]:
        kmers = telophrase_kmers("CCCTAAA", k)
        table = jnp.asarray(pack_kmer_table(kmers))
        rows = []
        for _ in range(6):
            s = _telomere_like(rng, "CCCTAAA", min(300, L), L)
            rows.append([ord(c) for c in s])
        codes = np.stack([encode_ascii(bytes(r)) for r in rows])
        # sprinkle invalid bases
        nprng = np.random.default_rng(k * 1000 + L)
        codes[nprng.random(codes.shape) < 0.01] = 4
        m = match_positions(jnp.asarray(codes), table, k)
        a = np.asarray(greedy_count_chunked(m, k))
        b = np.asarray(greedy_count_full(m, k))
        np.testing.assert_array_equal(a, b, err_msg=f"k={k} L={L}")


def test_greedy_count_oracle(rng):
    """Chunked greedy counter == python re.finditer count."""
    import re
    import jax.numpy as jnp
    from topsicle_tpu.ops import greedy_count_chunked, match_positions
    from topsicle_tpu.kmers import pack_kmer_table, encode_ascii

    kmers = telophrase_kmers("CCCTAAA", 5)
    table = jnp.asarray(pack_kmer_table(kmers))
    seqs = [_telomere_like(rng, "CCCTAAA", 400, 1000) for _ in range(8)]
    codes = np.stack([encode_ascii(s.encode()) for s in seqs])
    m = match_positions(jnp.asarray(codes), table, 5)
    got = np.asarray(greedy_count_chunked(m, 5))
    for i, s in enumerate(seqs):
        for j, km in enumerate(kmers):
            want = len(re.findall(re.escape(km), s.upper()))
            assert got[i, j] == want, (i, km)

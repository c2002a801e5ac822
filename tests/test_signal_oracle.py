"""The step-2 window signal and boundary, device path vs the host oracle.

`ops.boundary_sum_signal` (aperiodic tables) and the mixed-table split
(`models.telomere._boundary_y_split`: scan-free sum over the aperiodic
entries, exact bitmask/offset scans over the periodic few) are checked
against `oracle.reference.count_nonoverlapping`, the reference's
`re.finditer` semantics, on dirty batches (N bases, ragged suffix
padding) across seeds, tail lengths and (k, window, slide) geometries.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topsicle_tpu import ops
from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import aperiodic_mask, pack_kmer_table, patterns_to_search
from topsicle_tpu.models import TelomereScanModel
from topsicle_tpu.models.telomere import _boundary_y_split
from topsicle_tpu.oracle.reference import binseg_l2_single, count_nonoverlapping


def _dirty_tails(rng, B, L, pattern):
    """Telomere-prefixed reads with N bases and ragged suffix padding."""
    pat = np.frombuffer(pattern.encode(), np.uint8)
    lut = np.zeros(256, np.uint8)
    lut[list(b"ACGT")] = [0, 1, 2, 3]
    tails = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(L // 3, L + 1, B).astype(np.int32)
    for i in range(B):
        tl = int(rng.integers(100, L // 2))
        tails[i, :tl] = lut[np.tile(pat, tl // len(pat) + 1)[:tl]]
        tails[i, rng.integers(0, L, 3)] = 4            # N bases
        tails[i, lens[i]:] = 0xFF
    return tails, lens


def _oracle_y(tails, kmers, window_size, slide, W):
    """sum_i max(count_i, 1) per window, from the reference's greedy
    non-overlapping count on the decoded (N-poisoned) string."""
    alphabet = np.frombuffer(b"ACGTNNNN", np.uint8)
    out = np.zeros((tails.shape[0], W), np.int64)
    for b, row in enumerate(tails):
        s = alphabet[np.minimum(row, 4)].tobytes().decode()
        for j in range(W):
            win = s[j * slide: j * slide + window_size - 1]
            out[b, j] = sum(count_nonoverlapping(win, km) or 1 for km in kmers)
    return out


def _split_idx(kmers):
    mask = np.asarray(aperiodic_mask(kmers))
    assert mask.any() and not mask.all(), "table must be mixed"
    return np.nonzero(mask)[0], np.nonzero(~mask)[0]


def _sum_signal(tails, kmers, k, w, slide):
    W = (tails.shape[1] - w) // slide + 1
    fn = jax.jit(functools.partial(ops.boundary_sum_signal, k=k, window_size=w,
                                   slide=slide, num_windows=W))
    table = jnp.asarray(pack_kmer_table(kmers))
    return np.asarray(fn(jnp.asarray(tails), table)), W


def _split_signal(tails, kmers, k, w, slide):
    W = (tails.shape[1] - w) // slide + 1
    fn = jax.jit(functools.partial(_boundary_y_split, k=k, window_size=w,
                                   slide=slide, num_windows=W,
                                   split_idx=_split_idx(kmers)))
    table = jnp.asarray(pack_kmer_table(kmers))
    return np.asarray(fn(jnp.asarray(tails), table)), W


@pytest.mark.parametrize("seed,L", [(0, 2048), (1, 4096), (3, 2048), (7, 4096)])
def test_boundary_sum_signal_vs_oracle(seed, L):
    rng = np.random.default_rng(seed)
    kmers = patterns_to_search("CCCTAAA", 5)           # fully aperiodic
    tails, _ = _dirty_tails(rng, 4, L, "CCCTAAA")
    y, W = _sum_signal(tails, kmers, 5, 100, 6)
    np.testing.assert_array_equal(y, _oracle_y(tails, kmers, 100, 6, W))


@pytest.mark.parametrize("pattern,k,seed", [
    ("CCCTAA", 5, 0),      # 2 periodic entries: bitmask sub-scan
    ("CCCTAA", 6, 1),      # 6 periodic entries: offset sub-scan
    ("CCCTAAA", 6, 3),     # 4 periodic entries: bitmask sub-scan
    ("CCCTAAA", 7, 7),     # 8 periodic entries: offset sub-scan
])
def test_boundary_split_vs_oracle(pattern, k, seed):
    rng = np.random.default_rng(seed)
    kmers = patterns_to_search(pattern, k)
    tails, _ = _dirty_tails(rng, 4, 2048, pattern)
    y, W = _split_signal(tails, kmers, k, 100, len(pattern))
    np.testing.assert_array_equal(
        y, _oracle_y(tails, kmers, 100, len(pattern), W))


@pytest.mark.parametrize("k,w,slide", [
    (4, 64, 3),     # small window, slide < k
    (5, 100, 1),    # slide=1: every position starts a window
    (6, 80, 7),     # slide > k
    (7, 120, 7),    # long k-mers
])
def test_sum_signal_geometry_sweep(k, w, slide):
    """Random aperiodic tables across the window geometry space."""
    rng = np.random.default_rng(k * 100 + slide)
    kmers = set()
    while len(kmers) < 10:
        km = "".join(rng.choice(list("ACGT"), k))
        if aperiodic_mask([km])[0]:
            kmers.add(km)
    kmers = sorted(kmers)
    tails, _ = _dirty_tails(rng, 4, 1536, "CCCTAAA")
    y, W = _sum_signal(tails, kmers, k, w, slide)
    np.testing.assert_array_equal(y, _oracle_y(tails, kmers, w, slide, W))


@pytest.mark.parametrize("pattern,k,w,slide", [
    ("CCCTAAA", 3, 64, 3),    # 4 periodic entries, slide == k
    ("CCCTAA", 5, 100, 1),    # slide=1
    ("CCCTAA", 6, 80, 7),     # slide > k, offset sub-scan
    ("CCCTAAA", 7, 120, 7),   # 8 periodic entries, offset sub-scan
])
def test_split_signal_geometry_sweep(pattern, k, w, slide):
    rng = np.random.default_rng(k * 10 + slide)
    kmers = patterns_to_search(pattern, k)
    tails, _ = _dirty_tails(rng, 4, 1536, pattern)
    y, W = _split_signal(tails, kmers, k, w, slide)
    np.testing.assert_array_equal(y, _oracle_y(tails, kmers, w, slide, W))


@pytest.mark.parametrize("pattern,k,strategy", [
    ("CCCTAAA", 5, "sum"),
    ("CCCTAA", 4, "sum"),
    ("CCCTAA", 5, "split"),
    ("CCCTAA", 6, "split"),
])
def test_model_boundary_vs_oracle(pattern, k, strategy):
    """The model's step-2 launch (lean wire when a batch is clean, dense
    wire otherwise) gives the oracle's changepoint on every read."""
    rng = np.random.default_rng(k)
    kmers = patterns_to_search(pattern, k)
    slide = len(pattern)
    model = TelomereScanModel(kmers, window_size=100, slide=slide)
    assert model.window_strategy == strategy
    dirty, lens = _dirty_tails(rng, 8, 2048, pattern)
    clean = np.where(dirty == 4, 0, dirty).astype(np.uint8)
    for tails in (dirty, clean):
        nw = batching.window_counts_for_lengths(lens, 100, slide)
        t, has = model.step2_boundary(tails, nw, lens)
        y = _oracle_y(tails, kmers, 100, slide, int(nw.max()))
        for b in range(len(tails)):
            want = binseg_l2_single(list(y[b, :nw[b]] / len(kmers)))
            assert bool(has[b]) == (want is not None)
            if want is not None:
                assert int(t[b]) == want

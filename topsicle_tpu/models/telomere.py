"""The flagship device program: batched telomere scanning.

Two fused, jitted stages mirror the reference pipeline (SURVEY.md §1)
but batched over reads instead of looping per read/regex:

  step1: [B, 2, no_bp] end codes     -> [B, 2, K] greedy k-mer counts
         (TRC selection/cutoff runs on host in f64 — counts are tiny and
         the reference's float semantics are host float64)
  step2: [B, L] tail codes + lengths -> per-read changepoint t and the
         integer window signal (for --rawcountpattern)

Everything is integer; jit caches per (B, L) shape.  Multi-chip: the
same functions are wrapped by parallel.sharding for shard_map data
parallelism over the batch axis.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from topsicle_tpu import ops
from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import all_aperiodic, aperiodic_mask, pack_kmer_table


# ---- mixed-table split (strategy "split") -------------------------------
# Aperiodicity is a PER-ENTRY property: most production tables are mixed
# (human CCCTAA k=5: 2 of 12 entries self-overlap; CCCTAAA k=6: 4 of 14).
# The split strategy runs the aperiodic subset on the scan-free sum
# kernels and only the periodic few through the exact sequential scan,
# whose cost scales ~linearly in its entry count — the whole-table scan
# was the production fallback's 5x tax.  split_idx = (idx_a, idx_p):
# static numpy index arrays into the original table order (which TRC
# argmax tie-breaking depends on, so per-entry outputs scatter back).

def _split_counts_scatter(c_a, c_p, idx_a, idx_p, axis):
    """Concatenate per-subset results along `axis` (the K axis) and
    inverse-permute back to the ORIGINAL table order — which TRC argmax
    tie-breaking and rawcount CSV columns depend on.  The single home
    of this ordering-critical invariant."""
    inv = np.argsort(np.concatenate([idx_a, idx_p]))
    return jnp.take(jnp.concatenate([c_a, c_p], axis=axis),
                    jnp.asarray(inv), axis=axis)


def _sub_scan_strategy(n_periodic: int) -> str:
    """Exact-scan strategy for the periodic SUB-table: the bitmask
    chunk scan for subsets of at most 4 entries, the offset scan above
    that (all variants bit-identical).  The phase scan's lane packing
    only pays off at full table width, so it stays the all-periodic
    fallback.  The crossover was tuned on the previous accelerator and
    is not measured on the H100."""
    return "bitmask" if n_periodic <= 4 else "offset"


def _greedy_counts_split(match, k, split_idx, greedy_p="chunked"):
    """[B, K, Lp] match bits -> [B, K] greedy counts, mixed table:
    occurrence sums for the aperiodic entries, the exact greedy scan
    for the periodic ones."""
    idx_a, idx_p = split_idx
    c_a = match[:, idx_a, :].sum(axis=-1, dtype=jnp.int32)
    c_p = ops.greedy_count(match[:, idx_p, :], k, greedy_p)
    return _split_counts_scatter(c_a, c_p, idx_a, idx_p, axis=1)


def _boundary_y_split(codes, table, *, k, window_size, slide, num_windows,
                      split_idx):
    """Fused y_int for a mixed table: scan-free sum signal over the
    aperiodic subset + exact phase-scan floors over the periodic
    subset.  Exact: each entry is counted by a method valid for it."""
    idx_a, idx_p = split_idx
    y = ops.boundary_sum_signal(
        codes, table[np.asarray(idx_a)], k, window_size, slide, num_windows)
    match_p = ops.match_positions(codes, table[np.asarray(idx_p)], k)
    c_p = ops.window_nonoverlap_counts(
        match_p, k, window_size, slide, num_windows,
        strategy=_sub_scan_strategy(len(idx_p)))
    return y + jnp.maximum(c_p, 1).sum(axis=1)


def _step1_counts(ends_packed, ends_invalid, table, *, k: int,
                  greedy: str = "chunked", split_idx=None):
    """Packed [B, 2, no_bp/4] + mask [B, 2, no_bp/8] -> [B, 2, K] int32
    greedy counts.  Inputs use the 2-bit wire format (io.batch.pack_batch)
    to keep host->device traffic at 2.25 bits/base."""
    B, two, Lq = ends_packed.shape
    flat = ops.unpack_codes(
        ends_packed.reshape(B * two, Lq),
        ends_invalid.reshape(B * two, -1),
        Lq * 4,
    )
    match = ops.match_positions(flat, table, k)
    if greedy == "split":
        counts = _greedy_counts_split(match, k, split_idx)
    else:
        counts = ops.greedy_count(match, k, greedy)     # [B*2, K]
    return counts.reshape(B, two, -1)


def _per_k_window_counts(codes, table, *, k, window_size, slide, num_windows,
                         strategy, split_idx=None):
    """[B, L] codes -> [B, K, W] per-window counts, honoring the split
    strategy (per-subset methods, columns scattered back to the
    original table order, which TRC/rawcount consumers depend on)."""
    match = ops.match_positions(codes, table, k)
    if strategy == "split":
        # one rolling-codes + match pass; the subsets are row slices
        idx_a, idx_p = split_idx
        c_a = ops.window_nonoverlap_counts(
            match[:, idx_a, :], k, window_size, slide, num_windows,
            strategy="sum")
        c_p = ops.window_nonoverlap_counts(
            match[:, idx_p, :], k, window_size, slide, num_windows,
            strategy=_sub_scan_strategy(len(idx_p)))
        return _split_counts_scatter(c_a, c_p, idx_a, idx_p, axis=1)
    return ops.window_nonoverlap_counts(match, k, window_size, slide,
                                        num_windows, strategy=strategy)


def _step2_signal(tail_packed, tail_invalid, table, *, k: int, window_size: int,
                  slide: int, strategy: str = "offset", split_idx=None):
    """Packed tails -> per-window counts [B, K, W] int32.

    W is the static window count for the padded length; ragged reads are
    handled by the caller's per-read n_windows (padding decodes to the
    invalid base class, which never matches; padded windows are excluded
    by the candidate mask downstream)."""
    L = tail_packed.shape[-1] * 4
    num_windows = max(0, (L - window_size) // slide + 1)
    codes = ops.unpack_codes(tail_packed, tail_invalid, L)
    return _per_k_window_counts(codes, table, k=k, window_size=window_size,
                                slide=slide, num_windows=num_windows,
                                strategy=strategy, split_idx=split_idx)


def _step2_boundary(tail_packed, tail_invalid, n_windows, table, *, k: int,
                    window_size: int, slide: int, jump: int, min_size: int,
                    strategy: str = "offset", split_idx=None):
    L = tail_packed.shape[-1] * 4
    num_windows = max(0, (L - window_size) // slide + 1)
    if strategy == "sum" and int(table.shape[0]) <= 31:
        # Fused scan-free signal: never materializes [B, K, Lp]
        # (ops.boundary_sum_signal; exact for aperiodic tables, which is
        # what routes strategy='sum' here)
        codes = ops.unpack_codes(tail_packed, tail_invalid, L)
        y_int = ops.boundary_sum_signal(codes, table, k, window_size, slide,
                                        num_windows)
    elif strategy == "split":
        codes = ops.unpack_codes(tail_packed, tail_invalid, L)
        y_int = _boundary_y_split(codes, table, k=k, window_size=window_size,
                                  slide=slide, num_windows=num_windows,
                                  split_idx=split_idx)
    else:
        counts = _step2_signal(tail_packed, tail_invalid, table, k=k,
                               window_size=window_size, slide=slide,
                               strategy=strategy)
        y_int = jnp.maximum(counts, 1).sum(axis=1)  # [B, W] sum over K
    t, has = ops.binseg_l2_device(y_int, n_windows, jump=jump,
                                  min_size=min_size,
                                  y_max=int(table.shape[0]) * window_size)
    return t, has


# ---- lean wire format variants (2 bits/base + per-read lengths; no
# invalid-mask plane — ops.unpack_codes_len).  Chosen per batch by the
# host when no read contains a non-ACGT base (the common case); batches
# with N/other characters use the dense-mask programs above.  Both paths
# are bit-identical where both apply (tested). ---------------------------

def _step1_counts_lean(ends_packed, ends_len, table, *, k: int,
                       greedy: str = "chunked", split_idx=None):
    """Packed [B, 2, no_bp/4] + valid length [B] -> [B, 2, K] int32.
    Both end rows of a read share one valid length min(len, no_bp)
    (io.batch.extract_ends)."""
    B, two, Lq = ends_packed.shape
    lens = jnp.broadcast_to(ends_len[:, None], (B, two)).reshape(B * two)
    flat = ops.unpack_codes_len(ends_packed.reshape(B * two, Lq), lens, Lq * 4)
    match = ops.match_positions(flat, table, k)
    if greedy == "split":
        return _greedy_counts_split(match, k, split_idx).reshape(B, two, -1)
    return ops.greedy_count(match, k, greedy).reshape(B, two, -1)


def _step2_signal_lean(tail_packed, lens, table, *, k: int, window_size: int,
                       slide: int, strategy: str = "offset", split_idx=None):
    L = tail_packed.shape[-1] * 4
    num_windows = max(0, (L - window_size) // slide + 1)
    codes = ops.unpack_codes_len(tail_packed, lens, L)
    return _per_k_window_counts(codes, table, k=k, window_size=window_size,
                                slide=slide, num_windows=num_windows,
                                strategy=strategy, split_idx=split_idx)


def _step2_boundary_lean(tail_packed, lens, n_windows, table, *, k: int,
                         window_size: int, slide: int, jump: int, min_size: int,
                         strategy: str = "offset", split_idx=None):
    L = tail_packed.shape[-1] * 4
    num_windows = max(0, (L - window_size) // slide + 1)
    if strategy == "sum" and int(table.shape[0]) <= 31:
        codes = ops.unpack_codes_len(tail_packed, lens, L)
        y_int = ops.boundary_sum_signal(codes, table, k, window_size, slide,
                                        num_windows)
    elif strategy == "split":
        codes = ops.unpack_codes_len(tail_packed, lens, L)
        y_int = _boundary_y_split(codes, table, k=k, window_size=window_size,
                                  slide=slide, num_windows=num_windows,
                                  split_idx=split_idx)
    else:
        counts = _step2_signal_lean(tail_packed, lens, table, k=k,
                                    window_size=window_size, slide=slide,
                                    strategy=strategy)
        y_int = jnp.maximum(counts, 1).sum(axis=1)
    t, has = ops.binseg_l2_device(y_int, n_windows, jump=jump,
                                  min_size=min_size,
                                  y_max=int(table.shape[0]) * window_size)
    return t, has


def resolve_window_strategy(requested: str | None = None, *,
                            aperiodic: bool = False,
                            mixed: bool = False) -> str:
    """Pick the step-2 window-scan strategy (see ops.match for the
    catalogue).  Priority: explicit argument > TOPSICLE_WINDOW_STRATEGY
    env var > 'sum' when the whole k-mer table is aperiodic, 'split'
    when only some entries are (the usual production case — human
    CCCTAA k=5 has 2 periodic entries of 12), else 'phase'.

    'sum' replaces the sequential greedy scan with ~12 shift-add passes
    (exact because an aperiodic k-mer can never self-overlap, so greedy
    == occurrence count — kmers.all_aperiodic) and compiles in seconds
    everywhere.  'split' applies 'sum' to the aperiodic subset and the
    exact scan only to the periodic few (scan cost ~linear in entry
    count).  'phase' is the general-case scan (the window axis stays
    minor, so every scan step is one contiguous slice over all windows),
    bit-identical to 'offset' (property-tested)."""
    s = requested or os.environ.get("TOPSICLE_WINDOW_STRATEGY") \
        or ("sum" if aperiodic else ("split" if mixed else "phase"))
    if s not in ("offset", "phase", "bitmask", "sum", "split"):
        raise ValueError(f"unknown window strategy {s!r}")
    return s


def resolve_greedy_strategy(requested: str | None = None, *,
                            aperiodic: bool = False,
                            mixed: bool = False) -> str:
    """Pick the step-1 greedy-count strategy (ops.match.greedy_count).
    Priority: explicit argument > TOPSICLE_GREEDY_STRATEGY env var >
    'sum' when the table is aperiodic (plain reduction — exact, see
    resolve_window_strategy), 'split' when only some entries are, else
    'chunked' (a 64-position unrolled body per scan step; 'tree' is the
    log-depth alternative, bit-identical)."""
    s = requested or os.environ.get("TOPSICLE_GREEDY_STRATEGY") \
        or ("sum" if aperiodic else ("split" if mixed else "chunked"))
    if s not in ("chunked", "tree", "sum", "split"):
        raise ValueError(f"unknown greedy strategy {s!r}")
    return s


def _batch_is_clean(codes: np.ndarray, lens: np.ndarray) -> bool:
    """True iff every row's valid prefix is pure ACGT (codes < 4).

    Rows are suffix-padded with the invalid class, so a single vector
    pass suffices: the ACGT count equals the valid length exactly when
    no N/other base sits inside the prefix."""
    return bool(((codes < 4).sum(axis=1) == np.asarray(lens).reshape(-1)).all())


class TelomereScanModel:
    """Bound to one k-mer table (pattern x telophrase k); provides the
    jitted device entry points used by the engine, __graft_entry__, and
    the benchmarks."""

    def __init__(self, kmers: Sequence[str], *, window_size: int = 100,
                 slide: int = 7, jump: int = 5, min_size: int = 2,
                 window_strategy: str | None = None,
                 greedy_strategy: str | None = None):
        if not kmers:
            raise ValueError("empty k-mer table")
        self.kmers = list(kmers)
        self.k = len(kmers[0])
        self.K = len(kmers)
        self.window_size = window_size
        self.slide = slide
        self.jump = jump
        self.min_size = min_size
        # Aperiodicity is per entry (kmers.aperiodic_mask): a fully
        # aperiodic table (the default k=5 CCCTAAA one) takes the
        # scan-free sum kernels outright; a MIXED table (human CCCTAA
        # k=5: 2 periodic entries of 12) splits — sum kernels for the
        # aperiodic subset, the exact scan for the periodic few; a
        # fully periodic table keeps the exact scan.
        mask = np.asarray(aperiodic_mask(self.kmers))
        self.aperiodic = bool(mask.all())
        mixed = bool(mask.any()) and not self.aperiodic
        self.window_strategy = resolve_window_strategy(
            window_strategy, aperiodic=self.aperiodic, mixed=mixed)
        self.greedy_strategy = resolve_greedy_strategy(
            greedy_strategy, aperiodic=self.aperiodic, mixed=mixed)
        if not self.aperiodic:
            # A forced 'sum' on a not-fully-aperiodic table would
            # silently break greedy semantics — degrade to the exact
            # split/scan paths instead.
            import warnings
            fallback_w = "split" if mixed else "phase"
            fallback_g = "split" if mixed else "chunked"
            if self.window_strategy == "sum":
                warnings.warn("window strategy 'sum' requires an aperiodic "
                              f"k-mer table; falling back to {fallback_w!r}")
                self.window_strategy = fallback_w
            if self.greedy_strategy == "sum":
                warnings.warn("greedy strategy 'sum' requires an aperiodic "
                              f"k-mer table; falling back to {fallback_g!r}")
                self.greedy_strategy = fallback_g
        # 'split' on a homogeneous table degenerates to the right
        # single-path strategy (an empty subset would be a zero-width
        # program input)
        if self.window_strategy == "split" and not mixed:
            self.window_strategy = "sum" if self.aperiodic else "phase"
        if self.greedy_strategy == "split" and not mixed:
            self.greedy_strategy = "sum" if self.aperiodic else "chunked"
        if self.window_strategy == "split" and int(mask.sum()) > 31:
            # boundary_sum_signal's presence bit-plane holds at most 31
            # entries (same cap the 'sum' route guards): oversized
            # aperiodic subsets — possible with user-supplied k-mer
            # lists — keep the whole-table exact scan (greedy 'split'
            # has no such cap; match sums are plain reductions)
            self.window_strategy = "phase"
        self._split_idx = None
        if "split" in (self.window_strategy, self.greedy_strategy):
            self._split_idx = (np.nonzero(mask)[0], np.nonzero(~mask)[0])
        self.table = jnp.asarray(pack_kmer_table(self.kmers))

        self._step1 = jax.jit(functools.partial(
            _step1_counts, k=self.k, greedy=self.greedy_strategy,
            split_idx=self._split_idx))
        self._step2 = jax.jit(functools.partial(
            _step2_boundary, k=self.k, window_size=window_size, slide=slide,
            jump=jump, min_size=min_size, strategy=self.window_strategy,
            split_idx=self._split_idx))
        self._rawcounts = jax.jit(functools.partial(
            _step2_signal, k=self.k, window_size=window_size, slide=slide,
            strategy=self.window_strategy, split_idx=self._split_idx))
        self._rawcounts_lean = jax.jit(functools.partial(
            _step2_signal_lean, k=self.k, window_size=window_size,
            slide=slide, strategy=self.window_strategy,
            split_idx=self._split_idx))
        self._step1_lean = jax.jit(functools.partial(
            _step1_counts_lean, k=self.k, greedy=self.greedy_strategy,
            split_idx=self._split_idx))
        self._step2_lean = jax.jit(functools.partial(
            _step2_boundary_lean, k=self.k, window_size=window_size,
            slide=slide, jump=jump, min_size=min_size,
            strategy=self.window_strategy, split_idx=self._split_idx))

    # ---- host-facing API (numpy in / numpy out; packs on host) -----------
    def step1_counts_launch(self, ends_codes: np.ndarray,
                            ends_len: np.ndarray | None = None):
        """Async launch: returns the device array without syncing, so
        callers can keep batches in flight (transfer overlaps compute).

        With `ends_len` ([B] int32 valid length per read, = min(len,
        no_bp)) and an all-ACGT batch, the lean wire format ships 2
        bits/base; otherwise the dense-mask format is used (identical
        results)."""
        B = ends_codes.shape[0]
        flat = ends_codes.reshape(B * 2, -1)
        if ends_len is not None and _batch_is_clean(flat, np.repeat(ends_len, 2)):
            p = batching.pack_codes(flat)
            return self._step1_lean(
                jnp.asarray(p.reshape(B, 2, -1)),
                jnp.asarray(ends_len.astype(np.int32)),
                self.table,
            )
        p, m = batching.pack_batch(flat)
        return self._step1(
            jnp.asarray(p.reshape(B, 2, -1)),
            jnp.asarray(m.reshape(B, 2, -1)),
            self.table,
        )

    def step1_counts(self, ends_codes: np.ndarray,
                     ends_len: np.ndarray | None = None) -> np.ndarray:
        """[B, 2, no_bp] uint8 -> [B, 2, K] int32."""
        return np.asarray(self.step1_counts_launch(ends_codes, ends_len))

    def step2_boundary_launch(self, tail_codes: np.ndarray, n_windows: np.ndarray,
                              lens: np.ndarray | None = None):
        if lens is not None and _batch_is_clean(tail_codes, lens):
            p = batching.pack_codes(tail_codes)
            return self._step2_lean(
                jnp.asarray(p), jnp.asarray(lens.astype(np.int32)),
                jnp.asarray(n_windows), self.table
            )
        p, m = batching.pack_batch(tail_codes)
        return self._step2(
            jnp.asarray(p), jnp.asarray(m), jnp.asarray(n_windows), self.table
        )

    def step2_boundary(self, tail_codes: np.ndarray, n_windows: np.ndarray,
                       lens: np.ndarray | None = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """[B, L] uint8, [B] int32 -> (t [B] int64, has [B] bool)."""
        t, has = self.step2_boundary_launch(tail_codes, n_windows, lens)
        return np.asarray(t), np.asarray(has)

    # ---- shared-pack scan API: one host pack per batch feeds both the
    # boundary and the rawcounts programs.  --plot/--rawcountpattern
    # runs previously re-packed the identical batch dense (never lean)
    # and synced it inline. -----------------------------------------------
    def pack_scan_batch(self, tail_codes: np.ndarray,
                        lens: np.ndarray | None = None):
        """Host-pack one step-2 batch once: ('lean', packed, lens) for
        clean batches (2 bits/base wire) else ('dense', packed,
        invalid_bits)."""
        if lens is not None and _batch_is_clean(tail_codes, lens):
            return ("lean", batching.pack_codes(tail_codes),
                    lens.astype(np.int32))
        p, m = batching.pack_batch(tail_codes)
        return ("dense", p, m)

    def step2_boundary_launch_packed(self, packed, n_windows: np.ndarray):
        """Async boundary launch on a pack_scan_batch result."""
        kind, a, b = packed
        prog = self._step2_lean if kind == "lean" else self._step2
        return prog(jnp.asarray(a), jnp.asarray(b), jnp.asarray(n_windows),
                    self.table)

    def rawcounts_launch_packed(self, packed):
        """Async per-K window counts [B, K, W] on the SAME wire arrays
        as the boundary launch (no second pack, lean when clean)."""
        kind, a, b = packed
        prog = self._rawcounts_lean if kind == "lean" else self._rawcounts
        return prog(jnp.asarray(a), jnp.asarray(b), self.table)

    def rawcounts(self, tail_codes: np.ndarray,
                  lens: np.ndarray | None = None) -> np.ndarray:
        """[B, L] uint8 -> [B, K, W] int32 per-window counts (no or-1
        floor — the floor is applied by consumers, matching
        rawCountPattern's `or 1` at allsteps.py:402,408)."""
        return np.asarray(
            self.rawcounts_launch_packed(self.pack_scan_batch(tail_codes, lens)))

    def num_windows(self, length: int) -> int:
        if length < self.window_size:
            return 0
        return (length - self.window_size) // self.slide + 1

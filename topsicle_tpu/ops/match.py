"""k-mer matching and greedy non-overlap counting on device.

Batched array design (not a translation of the reference's regex loops —
allsteps.py:181-187,279-291):

- bases are small integer codes; a k-mer becomes one base-4 "rolling
  code", so matching is `k` shifted adds once per position, then one
  integer compare per table entry (elementwise, no string ops);
- `re.finditer`'s non-overlapping semantics are reproduced exactly.
  For APERIODIC k-mer tables (kmers.all_aperiodic — e.g. the default
  k=5 CCCTAAA table) greedy counting provably equals occurrence
  counting, so the scan-free "sum" strategies apply: windowed sums
  from doubling shift-adds, no sequential dependence.  Periodic
  tables use gather-free greedy scans: a (next_free, count) carry
  advanced uniformly over positions (contiguous slices, no gathers),
  with selectable window-scan strategies;
- everything is batched [B, ...] and int32; no floats anywhere.

Padding convention: invalid bases (N, gaps, padding) carry code >= 4 and
poison every k-mer window that touches them, so per-read ragged lengths
need no explicit masks.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

# Sentinel for "no further match"; must stay well below int32 overflow
# even after adding k.  A plain Python int: creating a jnp scalar at
# import time would initialize the XLA backend, which must not happen
# before jax.distributed.initialize() in multi-host runs.
_BIG = 1 << 30

MAX_ROLLING_K = 15  # 4**15 < 2**31; longer k-mers would overflow int32


def unpack_codes(packed: jax.Array, invalid_bits: jax.Array, L: int) -> jax.Array:
    """Device-side unpack of the 2-bit wire format (io.batch.pack_batch):
    [..., L/4] packed bases + [..., L/8] invalid bitmask -> [..., L]
    uint8 codes with invalid positions forced to code 4."""
    shifts2 = jnp.arange(4, dtype=jnp.uint8) * jnp.uint8(2)
    b = (packed[..., :, None] >> shifts2) & jnp.uint8(3)
    codes = b.reshape(*packed.shape[:-1], -1)[..., :L]
    shifts1 = jnp.arange(8, dtype=jnp.uint8)
    m = (invalid_bits[..., :, None] >> shifts1) & jnp.uint8(1)
    invalid = m.reshape(*invalid_bits.shape[:-1], -1)[..., :L]
    return jnp.where(invalid > 0, jnp.uint8(4), codes)


def unpack_codes_len(packed: jax.Array, lengths: jax.Array, L: int) -> jax.Array:
    """Device-side unpack of the *lean* wire format: [..., L/4] packed
    bases + [...] valid lengths -> [..., L] uint8 codes with positions
    >= length forced to the invalid class.

    This is the fast path for reads with no non-ACGT characters: the
    1-bit/base invalid-mask plane of `unpack_codes` is replaced by one
    int32 per read (padding is always a suffix in the batch layout), a
    ~33% cut in host->device wire traffic.  Reads containing N/other
    characters fall back to the dense-mask format (chosen per batch on
    host)."""
    shifts2 = jnp.arange(4, dtype=jnp.uint8) * jnp.uint8(2)
    b = (packed[..., :, None] >> shifts2) & jnp.uint8(3)
    codes = b.reshape(*packed.shape[:-1], -1)[..., :L]
    pos = jnp.arange(L, dtype=jnp.int32)
    invalid = pos >= lengths.astype(jnp.int32)[..., None]
    return jnp.where(invalid, jnp.uint8(4), codes)


def rolling_codes(codes: jax.Array, k: int, dtype=None):
    """[..., L] uint8 base codes -> ([..., L-k+1] rolling codes,
    [..., L-k+1] bool validity).

    code(p) = sum_j base[p+j] * 4**j; invalid wherever any base >= 4.
    dtype defaults to int32; the override is kept for experimentation
    only.  int16 (exact for k <= 7) halves the largest plane but made
    the fused sum program slower on the accelerator this was first
    tuned for (not measured on the H100), so no production caller
    passes dtype."""
    if k > MAX_ROLLING_K:
        raise ValueError(f"k={k} exceeds rolling-code capacity ({MAX_ROLLING_K})")
    if dtype is None:
        dtype = jnp.int32
    L = codes.shape[-1]
    Lp = L - k + 1
    if Lp <= 0:
        raise ValueError(f"sequence length {L} shorter than k={k}")
    c = codes.astype(dtype)
    val = jnp.zeros(codes.shape[:-1] + (Lp,), dtype)
    bad = jnp.zeros(codes.shape[:-1] + (Lp,), bool)
    for j in range(k):
        sl = jax.lax.slice_in_dim(c, j, j + Lp, axis=-1)
        val = val + sl * (4**j)
        bad = bad | (sl >= 4)
    return val, ~bad


def match_positions(codes: jax.Array, table: jax.Array, k: int) -> jax.Array:
    """[B, L] codes x [K] packed k-mer table -> [B, K, L-k+1] match bits.

    Table entries of -1 (k-mers not expressible as rolling codes, i.e.
    containing non-ACGT characters) never match — a documented deviation
    from the reference's literal regex for non-ACGT *patterns*."""
    val, ok = rolling_codes(codes, k)
    # [B, 1, Lp] == [K, 1] -> [B, K, Lp]
    eq = val[..., None, :] == table.astype(jnp.int32)[:, None]
    return eq & ok[..., None, :]


def next_match_table(match: jax.Array) -> jax.Array:
    """[B, K, Lp] match bits -> [B, K, Lp+1] next-match-at-or-after table
    (values are positions, or >= _BIG when none).  Column Lp is the
    always-empty sentinel slot."""
    idx = jax.lax.broadcasted_iota(jnp.int32, match.shape, len(match.shape) - 1)
    cand = jnp.where(match, idx, _BIG)
    nxt = jax.lax.cummin(cand, axis=len(match.shape) - 1, reverse=True)
    pad = jnp.full(match.shape[:-1] + (1,), _BIG, jnp.int32)
    return jnp.concatenate([nxt, pad], axis=-1)


def greedy_count(match: jax.Array, k: int, strategy: str | None = None) -> jax.Array:
    """Greedy non-overlapping match count per [B, K] row — dispatcher
    over the two bit-identical strategies (property-tested equal):

    - "chunked" (default): lax.scan over ceil(Lp/64) blocks whose body
      unrolls 64 per-position phase updates — few scan steps with a
      fat body, which compiles in seconds, where a naive Lp-step scan
      and the log-depth tree below compile far slower.  Step 1 is tiny
      either way.
    - "tree": the log-depth composition tree (greedy_count_full) —
      fewest dependent steps (CPU tests use it to cross-check the
      chunked path).

    Resolution: explicit argument > TOPSICLE_GREEDY_STRATEGY env var >
    "chunked".
    """
    import os

    s = strategy or os.environ.get("TOPSICLE_GREEDY_STRATEGY") or "chunked"
    if s == "chunked":
        return greedy_count_chunked(match, k)
    if s == "tree":
        return greedy_count_full(match, k)
    if s == "sum":
        return greedy_count_sum(match, k)
    raise ValueError(f"unknown greedy strategy {s!r}")


def greedy_count_sum(match: jax.Array, k: int) -> jax.Array:
    """Plain occurrence count — equal to the greedy non-overlapping
    count whenever the k-mer table is APERIODIC (kmers.all_aperiodic):
    an aperiodic k-mer's matches are always >= k apart, so finditer's
    blocking never skips one.  No scan, no carry — a single reduction
    the compiler schedules freely.  Callers must gate on aperiodicity
    (models.telomere does); k is accepted for signature symmetry."""
    del k
    return match.sum(axis=-1, dtype=jnp.int32)


def greedy_count_chunked(match: jax.Array, k: int, chunk: int = 64) -> jax.Array:
    """Greedy non-overlapping count via a chunked sequential scan.

    The greedy carry before position p is d = number of still-blocked
    positions (0 = free; k-1 right after a take).  A lax.scan walks
    ceil(Lp/chunk) position blocks; the body unrolls `chunk` updates

        take = match[p] & (d == 0)
        d    = take ? k-1 : max(d-1, 0);  count += take

    on the [B, K] carry.  Semantics: `len(list(re.finditer(kmer, s)))`
    (allsteps.py:182-183), exactly as greedy_count_full."""
    Lp = match.shape[-1]
    n = -(-Lp // chunk)
    pad = n * chunk - Lp
    mp = jnp.pad(match, [(0, 0)] * (match.ndim - 1) + [(0, pad)]) if pad else match
    # [n, ..., chunk]: scan axis leading, positions within a chunk minor
    xs = jnp.moveaxis(mp.reshape(*match.shape[:-1], n, chunk), -2, 0)
    # carry derived from the data so it inherits sharding/varyingness
    # under shard_map (a plain zeros constant trips the vma checker)
    d0 = (xs[0, ..., 0] * 0).astype(jnp.int32)
    c0 = d0

    def body(carry, mc):
        d, c = carry
        for j in range(chunk):
            take = mc[..., j] & (d == 0)
            d = jnp.where(take, k - 1, jnp.maximum(d - 1, 0))
            c = c + take.astype(jnp.int32)
        return (d, c), None

    (_, c), _ = jax.lax.scan(body, (d0, c0), xs)
    return c


def greedy_count_full(match: jax.Array, k: int) -> jax.Array:
    """Greedy non-overlapping match count over the whole position axis,
    per [B, K] row — `len(list(re.finditer(kmer, s)))` semantics.

    Log-depth formulation (no long sequential scan).  The
    greedy state before position p is d = number of still-blocked
    positions (0 = free, up to k-1 after a take), so each position is a
    tiny function on the k phases:

        f_p(d) = (k-1, +1)        if d == 0 and match[p]
               = (max(d-1,0), +0) otherwise

    and greedy counting is the composition f_{Lp-1} ∘ ... ∘ f_0
    evaluated at d = 0.  Function composition is associative, so the
    whole reduction runs as a balanced log2(Lp)-level tree of pairwise
    composes; each compose indexes the k-entry tables via a one-hot
    contraction (k <= 8: pure elementwise work, no gathers, no
    scan).  ~10 parallel levels replace the former Lp-step lax.scan
    (Lp ~ 1000 for step 1 — an order of magnitude faster on a real
    chip)."""
    phases = jnp.arange(k, dtype=jnp.int32)             # [k]
    m = match[..., None]                                # [B, K, Lp, 1]
    take = m & (phases == 0)
    out = jnp.where(take, k - 1, jnp.maximum(phases - 1, 0))
    out = jnp.broadcast_to(out, match.shape + (k,)).astype(jnp.int32)
    cnt = jnp.broadcast_to(take, match.shape + (k,)).astype(jnp.int32)

    # balanced pairwise composition over the position axis
    ax = match.ndim - 1                                 # position axis index
    while out.shape[ax] > 1:
        n = out.shape[ax]
        h = n // 2
        f_out = jax.lax.slice_in_dim(out, 0, 2 * h, 2, axis=ax)
        f_cnt = jax.lax.slice_in_dim(cnt, 0, 2 * h, 2, axis=ax)
        g_out = jax.lax.slice_in_dim(out, 1, 2 * h, 2, axis=ax)
        g_cnt = jax.lax.slice_in_dim(cnt, 1, 2 * h, 2, axis=ax)
        out2, cnt2 = _compose_phase_fns(f_out, f_cnt, g_out, g_cnt, k)
        if n % 2:
            tail_out = jax.lax.slice_in_dim(out, n - 1, n, axis=ax)
            tail_cnt = jax.lax.slice_in_dim(cnt, n - 1, n, axis=ax)
            out2 = jnp.concatenate([out2, tail_out], axis=ax)
            cnt2 = jnp.concatenate([cnt2, tail_cnt], axis=ax)
        out, cnt = out2, cnt2
    # evaluate the total composition at phase 0
    return cnt[..., 0, 0]


def _compose_phase_fns(f_out, f_cnt, g_out, g_cnt, k: int):
    """(g ∘ f) for batched k-phase functions: h(d) = g(f(d)), counts add.

    Table indexing g[f_out[d]] is a one-hot contraction over the tiny
    phase axis (k <= 8), which lowers to elementwise ops — no
    gathers."""
    oh = (f_out[..., None] == jnp.arange(k, dtype=jnp.int32)).astype(jnp.int32)
    # [..., d_in, j] x [..., j] -> [..., d_in]
    h_out = (oh * g_out[..., None, :]).sum(-1)
    h_cnt = f_cnt + (oh * g_cnt[..., None, :]).sum(-1)
    return h_out, h_cnt


def window_nonoverlap_counts(
    match: jax.Array, k: int, window_size: int, slide: int, num_windows: int,
    strategy: str = "offset",
) -> jax.Array:
    """Per-window greedy counts, [B, K, W] int32.

    Window w covers window_size-1 characters starting at w*slide (the
    reference's verified off-by-one, allsteps.py:221-224), so admissible
    match starts are w*slide + j for j in [0, window_size-1-k].  The
    greedy chain restarts at each window start.

    Gather-free strategies (bit-identical results where applicable,
    property-tested).  models.telomere.resolve_window_strategy picks
    "sum" for aperiodic k-mer tables (the common case) and "phase"
    otherwise; "offset"/"bitmask" remain selectable via
    TOPSICLE_WINDOW_STRATEGY:

    - "sum": scan-free sliding sums (_window_counts_sliding_sum) —
      exact only for aperiodic tables, where greedy == occurrence
      count; fastest path and cheapest to compile.
    - "phase": match bits decimated into `slide` phase planes so
      every scan step is one contiguous slice over all windows at once,
      with the window axis minor.
    - "offset": one lax.scan over the J = window_size - k in-window
      offsets with a (next_free, count) carry; each step is a
      contiguous dynamic slice of a [B, nb, slide, K] re-blocking of the
      match bits plus elementwise ops.  Compiles fast everywhere.
    - "bitmask": ~k x fewer scan steps — after a take the next k-1
      offsets are blocked, so each k-offset chunk admits at most one
      take, found via packed match-bit words + shift +
      count-trailing-zeros.  models.telomere._sub_scan_strategy
      selects it only for the small periodic subsets of mixed tables
      (K_p <= 4).
    """
    if strategy == "offset":
        return _window_counts_offset_scan(match, k, window_size, slide, num_windows)
    if strategy == "phase":
        return _window_counts_phase_scan(match, k, window_size, slide, num_windows)
    if strategy == "sum":
        return _window_counts_sliding_sum(match, k, window_size, slide, num_windows)
    if strategy != "bitmask":
        raise ValueError(f"unknown strategy {strategy!r}")
    J = window_size - k
    B, K, Lp = match.shape
    if J <= 0 or num_windows <= 0:
        return jnp.zeros((B, K, max(num_windows, 0)), jnp.int32)
    if k > 16:
        raise ValueError("bitmask chunk scan supports k <= 16")
    W = num_windows

    # mbits[p] = sum_d match[p+d] << d  (d in [0, k)) — int32 words.
    m32 = match.astype(jnp.int32)
    acc = jnp.zeros_like(m32)
    for d in range(k):
        sl = m32[..., d:] if d else m32
        sl = jnp.pad(sl, [(0, 0)] * (m32.ndim - 1) + [(0, d)])[..., :Lp]
        acc = acc | (sl << d)
    mbits = acc                                        # [B, K, Lp]

    nb = W + (J + slide - 1) // slide + 1
    pos = jnp.moveaxis(mbits, 1, 2)                    # [B, Lp, K]
    pad = nb * slide - Lp
    if pad > 0:
        pos = jnp.pad(pos, ((0, 0), (0, pad), (0, 0)))
    else:
        pos = pos[:, : nb * slide]
    blocks = pos.reshape(B, nb, slide, K)

    # carry derived from the data (see greedy_count_full on vma/sharding)
    nf0 = jnp.broadcast_to(blocks[:, :1, :1, 0] * 0, (B, W, K))
    cnt0 = nf0
    n_chunks = (J + k - 1) // k

    def body(carry, c):
        nf, cnt = carry
        base = c * k                                   # chunk start offset
        q = base // slide
        r = base % slide
        zero = jnp.int32(0)
        word = jax.lax.dynamic_slice(blocks, (zero, q, r, zero), (B, W, 1, K))[:, :, 0, :]
        # zero bits beyond J (partial last chunk) — J - base >= 1 here
        nvalid = jnp.minimum(J - base, k)
        word = word & ((jnp.int32(1) << nvalid) - 1)
        # block offsets below next_free
        shift = jnp.clip(nf - base, 0, 30)
        avail = (word >> shift) << shift
        take = avail != 0
        low = avail & -avail                           # lowest set bit
        j_rel = _popcount(low - 1)                     # its index
        nf = jnp.where(take, base + j_rel + k, nf)
        return (nf, cnt + take.astype(jnp.int32)), None

    (nf, cnt), _ = jax.lax.scan(
        body, (nf0, cnt0), jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return jnp.moveaxis(cnt, -1, 1)                    # [B, K, W]


def _shift_left_zero(x: jax.Array, n: int) -> jax.Array:
    """x[..., p] -> x[..., p+n], zero-filled at the tail (length kept)."""
    if n == 0:
        return x
    return jnp.pad(x[..., n:], [(0, 0)] * (x.ndim - 1) + [(0, n)])


def _sliding_reduce(x: jax.Array, width: int, op) -> jax.Array:
    """R[..., p] = op-fold of x[..., p : p+width] via log2(width)
    doubling steps (R_{2w}[p] = op(R_w[p], R_w[p+w])) plus one shifted
    combine per set bit of `width`.  Caller guarantees x is zero-padded
    far enough that tail zero-fill is the op's identity (true for add
    and bitwise-or on zero padding)."""
    pows = []
    s = x
    w = 1
    while w <= width:
        pows.append((w, s))
        if w * 2 > width:          # next doubling would go unused
            break
        s = op(s, _shift_left_zero(s, w))
        w *= 2
    total = None
    off = 0
    for w, sw in pows:              # LSB-first binary decomposition
        if width & w:
            part = _shift_left_zero(sw, off)
            total = part if total is None else op(total, part)
            off += w
    return total


def boundary_sum_signal(
    codes: jax.Array, table: jax.Array, k: int, window_size: int, slide: int,
    num_windows: int,
) -> jax.Array:
    """y_int [B, W] = sum_i max(count_i, 1) for APERIODIC tables,
    without ever materializing the [B, K, Lp] match tensor.

    Identity: sum_i max(c_i, 1) = (sum_i c_i) + #{i : c_i == 0}.  With
    aperiodicity, c_i is the plain number of entry-i matches among the
    window's J admissible offsets (see _window_counts_sliding_sum), so
      - sum_i c_i  = windowed SUM of the per-position total-match plane
        t[p] = #entries matching at p (int16; duplicate table entries
        each count, matching the reference's per-k-mer regexes), and
      - #zeros     = K - popcount(windowed OR of the per-position
        presence bit-plane w[p] = sum_i match_i[p] << i) — one int16
        word when K <= 15, int32 up to K <= 31
        (K <= 2*MAX_ROLLING_K + 2).
    Two planes replace K of them: ~K-fold less sliding work than per-K
    sums, and the [B, W] popcount is negligible.  Non-ACGT table
    entries (-1) never match and contribute their floor of 1 via the
    popcount term, exactly like the per-K paths.

    Two alternatives tried on the accelerator this was first tuned for
    did not win and were dropped (not measured on the H100): decimating
    both planes into `slide` phase planes before reducing, and
    lax.reduce_window in place of _sliding_reduce + strided slice."""
    J = window_size - k
    B = codes.shape[0]
    K = int(table.shape[0])
    if K > 31:
        raise ValueError("presence bit-plane holds at most 31 entries; "
                         "use the per-K 'sum' strategy for larger tables")
    if J <= 0 or num_windows <= 0:
        return jnp.zeros((B, max(num_windows, 0)), jnp.int32)
    # int32 rolling codes (see rolling_codes on int16)
    val, ok = rolling_codes(codes, k)            # [B, Lp]
    # windowed totals reach J*K — int16 only when that fits
    tdt = jnp.int16 if J * K < (1 << 15) else jnp.int32
    wdt = jnp.int16 if K <= 15 else jnp.int32
    tot = jnp.zeros(val.shape, tdt)
    word = jnp.zeros(val.shape, wdt)
    tv = table.astype(jnp.int32)
    for i in range(K):                           # K is small and static
        eq = (val == tv[i]) & ok
        tot = tot + eq.astype(tdt)
        word = word | (eq.astype(wdt) << i)
    W = num_windows
    need = (W - 1) * slide + J
    T = need + J
    padn = T - val.shape[-1]
    if padn > 0:
        pad = [(0, 0)] * (val.ndim - 1) + [(0, padn)]
        tot, word = jnp.pad(tot, pad), jnp.pad(word, pad)
    else:
        tot, word = tot[..., :T], word[..., :T]
    s = _sliding_reduce(tot, J, jnp.add)
    o = _sliding_reduce(word, J, jnp.bitwise_or)
    lim = (W - 1) * slide + 1
    s_w = jax.lax.slice(s, (0, 0), (B, lim), (1, slide)).astype(jnp.int32)
    o_w = jax.lax.slice(o, (0, 0), (B, lim), (1, slide))
    present = jax.lax.population_count(
        o_w.astype(jnp.uint32) & jnp.uint32((1 << K) - 1)).astype(jnp.int32)
    return s_w + (K - present)


def _window_counts_sliding_sum(
    match: jax.Array, k: int, window_size: int, slide: int, num_windows: int
) -> jax.Array:
    """Windowed occurrence-sum strategy — the scan-free fast path.

    ONLY exact for aperiodic k-mer tables (kmers.all_aperiodic): such a
    k-mer's matches are always >= k apart, so the greedy chain never
    blocks anything and the per-window greedy count equals the plain
    number of matches among the window's J = window_size - k admissible
    offsets.  That is a fixed-width sliding sum, built here from
    log2(J) doubling shift-adds (S_{2w}[p] = S_w[p] + S_w[p+w]) plus
    one shifted add per set bit of J, then sampled at the window starts
    with a stride-`slide` static slice.  ~12 elementwise passes replace
    the phase scan's ~J gated carry updates — no scan, no sequential
    dependence.  Sums fit int16 for any window_size < 32768 (values <= J).
    models.telomere gates selection on table aperiodicity."""
    J = window_size - k
    B, K, Lp = match.shape
    if J <= 0 or num_windows <= 0:
        return jnp.zeros((B, K, max(num_windows, 0)), jnp.int32)
    W = num_windows
    need = (W - 1) * slide + J      # one past the last offset any window reads
    T = need + J                    # cushion: shifted adds never wrap garbage
    padn = T - Lp
    m = jnp.pad(match, [(0, 0)] * (match.ndim - 1) + [(0, padn)]) if padn > 0 \
        else match[..., :T]
    dt = jnp.int16 if J < (1 << 15) else jnp.int32
    total = _sliding_reduce(m.astype(dt), J, jnp.add)
    counts = jax.lax.slice(
        total, (0,) * (match.ndim - 1) + (0,),
        match.shape[:-1] + ((W - 1) * slide + 1,),
        (1,) * (match.ndim - 1) + (slide,),
    )
    return counts.astype(jnp.int32)


def _popcount(x: jax.Array) -> jax.Array:
    return jax.lax.population_count(x.astype(jnp.uint32)).astype(jnp.int32)


def _window_counts_offset_scan(
    match: jax.Array, k: int, window_size: int, slide: int, num_windows: int
) -> jax.Array:
    """Per-offset scan strategy (see window_nonoverlap_counts).

    One lax.scan over the J in-window offsets; the per-offset plane is a
    contiguous dynamic slice of a [B, nb, slide, K] re-blocking of the
    match bits.  The minor axis is the small K; the phase-scan strategy
    below keeps the long window axis minor instead."""
    J = window_size - k
    B, K, Lp = match.shape
    if J <= 0 or num_windows <= 0:
        return jnp.zeros((B, K, max(num_windows, 0)), jnp.int32)
    W = num_windows
    nb = W + (J + slide - 1) // slide + 1
    pos = jnp.moveaxis(match, 1, 2)                     # [B, Lp, K]
    pad = nb * slide - Lp
    if pad > 0:
        pos = jnp.pad(pos, ((0, 0), (0, pad), (0, 0)))
    else:
        pos = pos[:, : nb * slide]
    blocks = pos.reshape(B, nb, slide, K)

    # carry derived from the data (see greedy_count_full on vma/sharding)
    nf0 = jnp.broadcast_to(blocks[:, :1, :1, 0].astype(jnp.int32) * 0, (B, W, K))
    cnt0 = nf0

    def body(carry, j):
        nf, cnt = carry
        q = j // slide
        r = j % slide
        zero = jnp.int32(0)
        m = jax.lax.dynamic_slice(blocks, (zero, q, r, zero), (B, W, 1, K))[:, :, 0, :]
        take = m & (j >= nf)
        return (jnp.where(take, j + k, nf), cnt + take.astype(jnp.int32)), None

    (nf, cnt), _ = jax.lax.scan(body, (nf0, cnt0), jnp.arange(J, dtype=jnp.int32))
    return jnp.moveaxis(cnt, -1, 1)                     # [B, K, W]


def _window_counts_phase_scan(
    match: jax.Array, k: int, window_size: int, slide: int, num_windows: int
) -> jax.Array:
    """Phase-plane scan strategy (see window_nonoverlap_counts).

    The window axis W stays the minor dimension throughout.  The match
    bits are decimated once into `slide` phase planes (phase r holds
    positions r, r+slide, ...), so the per-offset plane for ALL windows
    is one contiguous slice phases[r][..., j//slide : j//slide + W] —
    no transposes, no gathers.  The default for fully periodic
    tables."""
    J = window_size - k
    B, K, Lp = match.shape
    if J <= 0 or num_windows <= 0:
        return jnp.zeros((B, K, max(num_windows, 0)), jnp.int32)
    W = num_windows
    nq = W + (J + slide - 1) // slide + 1      # phase-plane length
    total = nq * slide
    pad = total - Lp
    mp = jnp.pad(match, ((0, 0), (0, 0), (0, pad))) if pad > 0 else match[..., :total]
    phases = [mp[..., r::slide] for r in range(slide)]   # each [B, K, nq]

    # Carry is int16 (nf <= J+k < 2^15, cnt <= J/1 < 2^15): the scan
    # carry round-trips device memory every step, so halving its width
    # halves the dominant traffic term.  Arithmetic happens in int32 in-register.
    # (Derived from the data so it inherits sharding/varyingness under
    # shard_map — a plain zeros constant trips the vma checker.)
    nf0 = jnp.broadcast_to(phases[0][:, :, :1].astype(jnp.int16) * 0, (B, K, W))
    cnt0 = nf0
    n_outer = (J + slide - 1) // slide

    def body(carry, q):
        # offsets j = q*slide + r, r unrolled statically so each phase
        # plane is indexed by a plain contiguous dynamic slice
        nf, cnt = (c.astype(jnp.int32) for c in carry)
        zero = jnp.int32(0)
        for r in range(slide):
            j = q * slide + r
            m = jax.lax.dynamic_slice(phases[r], (zero, zero, q), (B, K, W))
            take = m & (j >= nf) & (j < J)
            nf = jnp.where(take, j + k, nf)
            cnt = cnt + take.astype(jnp.int32)
        return (nf.astype(jnp.int16), cnt.astype(jnp.int16)), None

    (nf, cnt), _ = jax.lax.scan(
        body, (nf0, cnt0), jnp.arange(n_outer, dtype=jnp.int32)
    )
    return cnt.astype(jnp.int32)                        # [B, K, W]

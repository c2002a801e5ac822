"""Single-changepoint binary segmentation (L2 cost) on device, exact.

Equivalent of ruptures 1.1.9 `Binseg(model="l2").predict(n_bkps=1)` as
used by the reference (allsteps.py:310-311), re-derived for batched
integer arithmetic on device:

minimizing  cost(y[:t]) + cost(y[t:])  with cost = sum((y-mean)^2)  is
equivalent to maximizing

    g(t) = (n*S_t - t*S_n)^2 / (t*(n-t)),

where S is the prefix sum of y.  With the integer window signal
Y = K*y (sum of counts-or-1 over the K k-mers) the argmax is identical,
so the whole decision is integer arithmetic: A = n*S_t - t*S_n and
D = t*(n-t) in int64, and cross-comparison A1^2*D2 vs A2^2*D1 in exact
128+-bit arithmetic via 32-bit limbs (fp32 cannot resolve these
magnitudes, and integers keep every backend bit-identical).  Ties break to the smaller t
(first-best-wins, the verified ruptures behavior — SURVEY.md §8 item 9).

Candidates follow ruptures' sub-sampling: t a multiple of `jump` with
min_size <= t <= n - min_size.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Plain Python int (a jnp scalar here would initialize the XLA backend
# at import time, breaking jax.distributed.initialize in multi-host
# runs); ANDing with a uint64 array promotes it correctly under x64.
_M32 = 0xFFFFFFFF


def _sq_limbs(a):
    """|a|^2 for int64 a, as 4 uint64 limbs (base 2**32, little-endian)."""
    ua = jnp.abs(a).astype(jnp.uint64)
    hi = ua >> jnp.uint64(32)
    lo = ua & _M32
    ll = lo * lo
    hl = hi * lo            # < 2**63 (hi < 2**31)
    hh = hi * hi
    l0 = ll & _M32
    acc1 = (ll >> jnp.uint64(32)) + ((hl & _M32) << jnp.uint64(1))
    l1 = acc1 & _M32
    acc2 = (acc1 >> jnp.uint64(32)) + ((hl >> jnp.uint64(32)) << jnp.uint64(1)) + (hh & _M32)
    l2 = acc2 & _M32
    l3 = (acc2 >> jnp.uint64(32)) + (hh >> jnp.uint64(32))
    return (l0, l1, l2, l3)


def _mul_limbs_1(sq, d):
    """4-limb value times nonnegative d < 2**32 -> 5 uint64 limbs.

    The common case: d = t*(n-t) <= W**2/4 fits one 32-bit limb for any
    W <= 131071 windows (at W = 131072 exactly, W**2/4 = 2**32 overflows
    the limb and binseg_l2_device's (W*W)//4 <= 0xFFFFFFFF guard selects
    _mul_limbs instead), so the d-high products of _mul_limbs vanish
    statically (picked by binseg_l2_device per shape)."""
    l0, l1, l2, l3 = sq
    d0 = d.astype(jnp.uint64)
    s32 = jnp.uint64(32)
    p0, p1, p2, p3 = l0 * d0, l1 * d0, l2 * d0, l3 * d0
    r0 = p0 & _M32
    acc = (p0 >> s32) + (p1 & _M32)
    r1 = acc & _M32
    acc = (acc >> s32) + (p1 >> s32) + (p2 & _M32)
    r2 = acc & _M32
    acc = (acc >> s32) + (p2 >> s32) + (p3 & _M32)
    r3 = acc & _M32
    r4 = (acc >> s32) + (p3 >> s32)
    return (r0, r1, r2, r3, r4)


def _mul_limbs(sq, d):
    """4-limb value times nonnegative int64 d -> 6 uint64 limbs."""
    l0, l1, l2, l3 = sq
    ud = d.astype(jnp.uint64)
    d0 = ud & _M32
    d1 = ud >> jnp.uint64(32)
    p0, p1, p2, p3 = l0 * d0, l1 * d0, l2 * d0, l3 * d0
    q0, q1, q2, q3 = l0 * d1, l1 * d1, l2 * d1, l3 * d1
    s32 = jnp.uint64(32)
    r0 = p0 & _M32
    acc = (p0 >> s32) + (p1 & _M32) + (q0 & _M32)
    r1 = acc & _M32
    acc = (acc >> s32) + (p1 >> s32) + (p2 & _M32) + (q0 >> s32) + (q1 & _M32)
    r2 = acc & _M32
    acc = (acc >> s32) + (p2 >> s32) + (p3 & _M32) + (q1 >> s32) + (q2 & _M32)
    r3 = acc & _M32
    acc = (acc >> s32) + (p3 >> s32) + (q2 >> s32) + (q3 & _M32)
    r4 = acc & _M32
    r5 = (acc >> s32) + (q3 >> s32)
    return (r0, r1, r2, r3, r4, r5)


def _cmp(x, y):
    """Lexicographic compare of equal-length limb tuples -> (gt, eq)."""
    gt = jnp.zeros_like(x[0], dtype=bool)
    eq = jnp.ones_like(x[0], dtype=bool)
    for xi, yi in zip(reversed(x), reversed(y)):
        gt = gt | (eq & (xi > yi))
        eq = eq & (xi == yi)
    return gt, eq


def _pick(c1, c2, mul):
    """Tournament step: pick the better candidate of two.

    Candidate = (sq 4-limb tuple of A^2, D int64, t int64, valid bool);
    A's square limbs are computed ONCE before the tournament and carried
    through (they are what every level needs — recomputing the square
    per level tripled the limb work).  Better means larger A^2/D; exact
    ties go to smaller t; invalid always loses.  `mul` is _mul_limbs or
    the 1-limb specialization."""
    s1, d1, t1, v1 = c1
    s2, d2, t2, v2 = c2
    gt, eq = _cmp(mul(s1, d2), mul(s2, d1))
    take1 = (~v2) | (v1 & (gt | (eq & (t1 <= t2))))
    pick = lambda u, w: jnp.where(take1, u, w)
    sq = tuple(pick(a, b) for a, b in zip(s1, s2))
    return (sq, pick(d1, d2), pick(t1, t2), v1 | v2)


def binseg_l2_device(y_int, num_windows, jump: int = 5, min_size: int = 2,
                     y_max: int | None = None):
    """Exact argmax changepoint per batch row.

    y_int:        [B, W] integer window signal (any integer dtype)
    num_windows:  [B] valid-window count n per read (ragged batches)
    y_max:        optional static bound on y_int values; when
                  W * y_max fits int32 the full-width cumsum — the
                  only [B, W]-sized term here — runs in int32 instead
                  of int64 (half the bytes; the downstream A/D
                  arithmetic is [B, J] = W/jump-sized and stays
                  int64).  Callers with a
                  known signal cap (the window scan: y <= K*(J+1))
                  pass it; exactness is unaffected either way.
    Returns (t [B] int64, has_candidate [B] bool); t is the left-segment
    length in windows (boundary bp = trimfirst + slide*t downstream).
    """
    B, W = y_int.shape
    # Full-width cumsum + static gather at the candidate positions.
    # (A jump-block variant — reshape [B, J, jump].sum(-1) + short
    # cumsum — was slower on the accelerator this was first tuned for:
    # its minor axis is only `jump` wide.  Not measured on the H100.)
    if y_max is not None and W * y_max <= 0x7FFFFFFF:
        S = jnp.cumsum(y_int.astype(jnp.int32), axis=1)
    else:
        S = jnp.cumsum(y_int.astype(jnp.int64), axis=1)
    n32 = num_windows.astype(jnp.int32)
    n = num_windows.astype(jnp.int64)[:, None]                      # [B,1]
    Sn = jnp.take_along_axis(S, jnp.maximum(n32 - 1, 0)[:, None].astype(S.dtype), axis=1).astype(jnp.int64)  # [B,1]

    J = W // jump
    if J < 1:
        return jnp.zeros((B,), jnp.int64), jnp.zeros((B,), bool)
    t_np = np.arange(1, J + 1, dtype=np.int64) * jump               # static candidates
    St = S[:, t_np - 1].astype(jnp.int64)                           # [B,J]
    t = jnp.asarray(t_np)[None, :]                                  # [1,J]
    A = n * St - t * Sn
    D = t * (n - t)
    valid = (t >= min_size) & (t <= n - min_size)

    # Pad to a power of two and reduce pairwise (candidate order is
    # ascending t, so the in-pair tie rule t1<=t2 keeps first-best-wins).
    Jp = 1 << (J - 1).bit_length()
    pad = Jp - J

    def padf(x, fill):
        return jnp.pad(x, ((0, 0), (0, pad)), constant_values=fill) if pad else x

    A = padf(A, 0)
    D = padf(jnp.broadcast_to(D, (B, J)), 1)
    tt = padf(jnp.broadcast_to(t, (B, J)), 0)
    valid = padf(jnp.broadcast_to(valid, (B, J)), False)

    # D = t*(n-t) <= W^2/4: one 32-bit limb suffices for W <= 131071
    mul = _mul_limbs_1 if (W * W) // 4 <= 0xFFFFFFFF else _mul_limbs
    sq = _sq_limbs(A)
    # Pair CONTIGUOUS halves each level: contiguous slices need no
    # relayout, where strided pairings (0::2/1::2) did on the
    # accelerator this was first tuned for (a 4-ary tree and a
    # transposed [m, B] layout did not win there either; none is
    # measured on the H100).  The tie rule compares actual t values
    # inside _pick, so the tree shape cannot change the first-best-wins
    # result.
    while D.shape[1] > 1:
        h = D.shape[1] // 2
        sq, D, tt, valid = _pick(
            (tuple(s[:, :h] for s in sq), D[:, :h], tt[:, :h], valid[:, :h]),
            (tuple(s[:, h:] for s in sq), D[:, h:], tt[:, h:], valid[:, h:]),
            mul,
        )
    return tt[:, 0], valid[:, 0]

"""Device ops (JAX/XLA).

The whole device pipeline is pure-integer — base codes, match bits,
counts, prefix sums, and an exact int64/uint64-limb changepoint argmax —
so results are bit-stable across backends (CPU == GPU), mesh shapes, and
batch orders.  64-bit mode is required for the changepoint arithmetic and
is enabled here, before any tracing.
"""

import jax

jax.config.update("jax_enable_x64", True)

from topsicle_tpu.ops.match import (  # noqa: F401,E402
    boundary_sum_signal,
    greedy_count,
    greedy_count_chunked,
    greedy_count_full,
    greedy_count_sum,
    match_positions,
    next_match_table,
    rolling_codes,
    unpack_codes,
    unpack_codes_len,
    window_nonoverlap_counts,
)
from topsicle_tpu.ops.changepoint import binseg_l2_device  # noqa: F401,E402

"""shard_map data parallelism for the scan programs.

Each chip runs the identical integer pipeline on its batch shard; the
k-mer table is replicated; per-read records (counts / changepoints) are
all-gathered so every host sees the full batch result.  Because the
device path is integer-exact, the gathered results are bit-identical to
a single-chip run — tested on the virtual 8-device CPU mesh.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from topsicle_tpu.models.telomere import (
    _batch_is_clean,
    _step1_counts,
    _step1_counts_lean,
    _step2_boundary,
    _step2_boundary_lean,
)
from topsicle_tpu.parallel.mesh import DATA_AXIS, data_mesh


class ShardedScanModel:
    """Wraps a TelomereScanModel's device programs in shard_map over a
    1-D mesh; host-facing API is identical (numpy in / numpy out) but
    batches must be divisible by the mesh size (callers pad)."""

    def __init__(self, base, mesh=None):
        self.base = base
        self.mesh = mesh if mesh is not None else data_mesh()
        self.n = int(np.prod([self.mesh.shape[a] for a in self.mesh.axis_names]))
        k = base.k

        step1 = functools.partial(_step1_counts, k=k,
                                  greedy=base.greedy_strategy,
                                  split_idx=base._split_idx)
        step2 = functools.partial(
            _step2_boundary, k=k, window_size=base.window_size,
            slide=base.slide, jump=base.jump, min_size=base.min_size,
            strategy=base.window_strategy, split_idx=base._split_idx,
        )

        spec_b = P(DATA_AXIS)      # shard batch axis
        spec_r = P()               # replicated

        self._step1 = jax.jit(shard_map(
            step1, mesh=self.mesh,
            in_specs=(spec_b, spec_b, spec_r), out_specs=spec_b))
        self._step2 = jax.jit(shard_map(
            step2, mesh=self.mesh,
            in_specs=(spec_b, spec_b, spec_b, spec_r),
            out_specs=(spec_b, spec_b)))

        step1_lean = functools.partial(_step1_counts_lean, k=k,
                                       greedy=base.greedy_strategy,
                                       split_idx=base._split_idx)
        step2_lean = functools.partial(
            _step2_boundary_lean, k=k, window_size=base.window_size,
            slide=base.slide, jump=base.jump, min_size=base.min_size,
            strategy=base.window_strategy, split_idx=base._split_idx,
        )
        self._step1_lean = jax.jit(shard_map(
            step1_lean, mesh=self.mesh,
            in_specs=(spec_b, spec_b, spec_r), out_specs=spec_b))
        self._step2_lean = jax.jit(shard_map(
            step2_lean, mesh=self.mesh,
            in_specs=(spec_b, spec_b, spec_b, spec_r),
            out_specs=(spec_b, spec_b)))

    # -- host-facing API (packs on host, same wire format as the base) -----
    def step1_counts_launch(self, ends_codes: np.ndarray,
                            ends_len: np.ndarray | None = None):
        from topsicle_tpu.io import batch as batching

        B = ends_codes.shape[0]
        assert B % self.n == 0, "batch not divisible by mesh"
        flat = ends_codes.reshape(B * 2, -1)
        if ends_len is not None and _batch_is_clean(flat, np.repeat(ends_len, 2)):
            p = batching.pack_codes(flat)
            return self._step1_lean(
                jnp.asarray(p.reshape(B, 2, -1)),
                jnp.asarray(ends_len.astype(np.int32)),
                self.base.table,
            )
        p, m = batching.pack_batch(flat)
        return self._step1(
            jnp.asarray(p.reshape(B, 2, -1)),
            jnp.asarray(m.reshape(B, 2, -1)),
            self.base.table,
        )

    def step1_counts(self, ends_codes: np.ndarray,
                     ends_len: np.ndarray | None = None) -> np.ndarray:
        return np.asarray(self.step1_counts_launch(ends_codes, ends_len))

    def step2_boundary_launch(self, tail_codes: np.ndarray, n_windows: np.ndarray,
                              lens: np.ndarray | None = None):
        from topsicle_tpu.io import batch as batching

        B = tail_codes.shape[0]
        assert B % self.n == 0, "batch not divisible by mesh"
        if lens is not None and _batch_is_clean(tail_codes, lens):
            p = batching.pack_codes(tail_codes)
            return self._step2_lean(
                jnp.asarray(p), jnp.asarray(lens.astype(np.int32)),
                jnp.asarray(n_windows), self.base.table
            )
        p, m = batching.pack_batch(tail_codes)
        return self._step2(
            jnp.asarray(p), jnp.asarray(m), jnp.asarray(n_windows), self.base.table
        )

    def step2_boundary(self, tail_codes: np.ndarray, n_windows: np.ndarray,
                       lens: np.ndarray | None = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        t, has = self.step2_boundary_launch(tail_codes, n_windows, lens)
        return np.asarray(t), np.asarray(has)

    def rawcounts(self, tail_codes: np.ndarray,
                  lens: np.ndarray | None = None) -> np.ndarray:
        return self.base.rawcounts(tail_codes, lens)

    # shared-pack scan API (models.telomere): boundary runs sharded on
    # the same wire arrays; rawcounts (per-read extras) stays on the
    # base single-device program like global mode's extras
    def pack_scan_batch(self, tail_codes: np.ndarray,
                        lens: np.ndarray | None = None):
        return self.base.pack_scan_batch(tail_codes, lens)

    def step2_boundary_launch_packed(self, packed, n_windows: np.ndarray):
        kind, a, b = packed
        prog = self._step2_lean if kind == "lean" else self._step2
        return prog(jnp.asarray(a), jnp.asarray(b), jnp.asarray(n_windows),
                    self.base.table)

    def rawcounts_launch_packed(self, packed):
        return self.base.rawcounts_launch_packed(packed)

    # passthroughs
    @property
    def kmers(self):
        return self.base.kmers

    def num_windows(self, length: int) -> int:
        return self.base.num_windows(length)

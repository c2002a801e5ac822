"""Global-mesh data parallelism: one logical batch sharded over every
chip of every host.

The file-sharded mode (parallel.distributed) keeps each host's compute
on its own chips; this mode instead forms a GLOBAL read batch — each
host contributes its local shard via
`jax.make_array_from_process_local_data` — and lets GSPMD partition the
scan programs over the whole mesh, with results replicated back to all
hosts (XLA inserts the all-gather, which NCCL carries between cards).
Compute load balances across all cards even when processes' input files
are skewed.

Reference analog: none — the reference's cross-node story is manual
SLURM job splitting (README.md:261-270).  Validated two-process on CPU
devices in tests/test_multihost.py (jax.distributed over gloo).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class GlobalScanModel:
    """Wraps a TelomereScanModel: same lean host API, but inputs are
    process-local shards of a global batch and outputs are the FULL
    global results (replicated on every host).

    Callers slice out their own rows: rows [pid*B_local, (pid+1)*B_local)
    belong to this process (make_array_from_process_local_data
    concatenates local shards in process order for a 1-D mesh laid out
    process-major, which jax.devices() is).
    """

    def __init__(self, base):
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        self.base = base
        devs = np.array(jax.devices())
        self.mesh = Mesh(devs.reshape(-1), ("data",))
        self.n_dev = devs.size
        self.n_proc = jax.process_count()
        self.pid = jax.process_index()
        self._shard = NamedSharding(self.mesh, P("data"))
        self._shard2 = NamedSharding(self.mesh, P("data", None))
        self._shard3 = NamedSharding(self.mesh, P("data", None, None))
        self._repl = NamedSharding(self.mesh, P())

        import functools

        from topsicle_tpu.models.telomere import (
            _step1_counts, _step1_counts_lean, _step2_boundary,
            _step2_boundary_lean)

        self._step1 = jax.jit(
            functools.partial(_step1_counts_lean, k=base.k,
                              greedy=base.greedy_strategy,
                              split_idx=base._split_idx),
            in_shardings=(self._shard3, self._shard, self._repl),
            out_shardings=self._repl,
        )
        self._step2 = jax.jit(
            functools.partial(
                _step2_boundary_lean, k=base.k, window_size=base.window_size,
                slide=base.slide, jump=base.jump, min_size=base.min_size,
                strategy=base.window_strategy, split_idx=base._split_idx,
            ),
            in_shardings=(self._shard2, self._shard, self._shard, self._repl),
            out_shardings=(self._repl, self._repl),
        )
        # dense-mask variants for batches where ANY host has a read with
        # an in-prefix non-ACGT base (the lean/dense choice must be
        # agreed by all processes — a host-local fallback would have
        # processes calling different programs and deadlock)
        self._step1_dense = jax.jit(
            functools.partial(_step1_counts, k=base.k,
                              greedy=base.greedy_strategy,
                              split_idx=base._split_idx),
            in_shardings=(self._shard3, self._shard3, self._repl),
            out_shardings=self._repl,
        )
        self._step2_dense = jax.jit(
            functools.partial(
                _step2_boundary, k=base.k, window_size=base.window_size,
                slide=base.slide, jump=base.jump, min_size=base.min_size,
                strategy=base.window_strategy, split_idx=base._split_idx,
            ),
            in_shardings=(self._shard2, self._shard2, self._shard, self._repl),
            out_shardings=(self._repl, self._repl),
        )

    # ---- host API: local shard in, global (replicated) results out ------
    def _globalize(self, sharding, local: np.ndarray):
        import jax

        return jax.make_array_from_process_local_data(sharding, local)

    def step1_counts_global_launch(self, local_ends: np.ndarray,
                                   local_len: np.ndarray,
                                   dense: bool = False):
        """Async variant: dispatches the global step-1 program and
        returns the (replicated) device array WITHOUT syncing, so the
        engine can keep a batch in flight while the hosts build the
        next one (sync with np.asarray)."""
        from topsicle_tpu.io import batch as batching

        B = local_ends.shape[0]
        if dense:
            p, m = batching.pack_batch(local_ends.reshape(B * 2, -1))
            g_ends = self._globalize(self._shard3, p.reshape(B, 2, -1))
            g_mask = self._globalize(self._shard3, m.reshape(B, 2, -1))
            return self._step1_dense(g_ends, g_mask, self.base.table)
        p = batching.pack_codes(local_ends.reshape(B * 2, -1)).reshape(B, 2, -1)
        g_ends = self._globalize(self._shard3, p)
        g_len = self._globalize(self._shard, local_len.astype(np.int32))
        return self._step1(g_ends, g_len, self.base.table)

    def step1_counts_global(self, local_ends: np.ndarray,
                            local_len: np.ndarray,
                            dense: bool = False) -> np.ndarray:
        """[B_local, 2, no_bp] uint8 codes + [B_local] lengths ->
        [B_global, 2, K] int32 counts, replicated (B_global = B_local *
        n_proc; all processes must call with equal B_local and the SAME
        `dense` flag — agree via any_process_has_data on cleanliness)."""
        return np.asarray(self.step1_counts_global_launch(
            local_ends, local_len, dense=dense))

    def step2_boundary_global_launch(self, local_tails: np.ndarray,
                                     local_nw: np.ndarray,
                                     local_lens: np.ndarray,
                                     dense: bool = False):
        """Async variant of step2_boundary_global: returns (t, has)
        device arrays without syncing."""
        from topsicle_tpu.io import batch as batching

        g_nw = self._globalize(self._shard, local_nw.astype(np.int32))
        if dense:
            p, m = batching.pack_batch(local_tails)
            g_tails = self._globalize(self._shard2, p)
            g_mask = self._globalize(self._shard2, m)
            return self._step2_dense(g_tails, g_mask, g_nw, self.base.table)
        p = batching.pack_codes(local_tails)
        g_tails = self._globalize(self._shard2, p)
        g_lens = self._globalize(self._shard, local_lens.astype(np.int32))
        return self._step2(g_tails, g_lens, g_nw, self.base.table)

    def step2_boundary_global(self, local_tails: np.ndarray,
                              local_nw: np.ndarray, local_lens: np.ndarray,
                              dense: bool = False
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """[B_local, L] uint8 codes -> global (t, has), replicated."""
        t, has = self.step2_boundary_global_launch(
            local_tails, local_nw, local_lens, dense=dense)
        return np.asarray(t), np.asarray(has)

    def my_rows(self, global_arr: np.ndarray, B_local: int) -> np.ndarray:
        """This process's slice of a replicated global result."""
        return global_arr[self.pid * B_local : (self.pid + 1) * B_local]

    # passthroughs used by the engine
    @property
    def kmers(self):
        return self.base.kmers

    def num_windows(self, length: int) -> int:
        return self.base.num_windows(length)


def or_across_processes(flags: np.ndarray) -> np.ndarray:
    """Element-wise OR of a small bool vector across all processes —
    the lockstep control word for streaming global batches (bit
    meanings are defined by the caller: see the unified scheduler in
    pipeline._run_phrase_global).  Host-level collective, one tiny
    allgather per iteration."""
    import jax

    flags = np.asarray(flags, dtype=np.bool_)
    if jax.process_count() == 1:
        return flags
    from jax.experimental import multihost_utils

    gathered = np.asarray(multihost_utils.process_allgather(flags))
    return gathered.reshape(jax.process_count(), -1).any(axis=0)


def any_process_has_data(flag: bool) -> bool:
    """OR of one bool across processes (see or_across_processes)."""
    return bool(or_across_processes(np.array([flag]))[0])

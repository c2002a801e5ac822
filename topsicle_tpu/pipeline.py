"""The device engine: streaming host pipeline + batched device programs.

Orchestration parity with the reference (main.py:52-154,156-309) but
batched, device-resident, and fully streamed (round 4):

  parse blocks (C++ or Python reader; the encoded-block cache replays
  later telophrases) ──► step-1 batches [B, 2, no_bp] ──► device
  greedy counts ──► host f64 TRC selection (argmax / tie / strict
  cutoff — reference float semantics, allsteps.py:178-198)
     └─ passers stream STRAIGHT into step-2 batches [B, L] ──► device
        window counts + exact changepoint, overlapping step 1's scan
        of later blocks; peak host memory stays O(batch)
  subset FASTQ/FASTA written once per file when its stream completes
  (resume artifact, main.py:64-87) — step 2 uses the in-memory tail
  slices, never re-parsing the subset file (the reference's O(K^2)
  re-parse, allsteps.py:252-258, is deliberately not replicated)
  CSV rows buffer per (file, k) unit and flush when the unit completes
  (a unit failing mid-stream contributes nothing), in input-read order
  aggregation/quadfit on host f64 (aggregate.py)

CSV rows, subset files, and aggregate log lines are bit-compatible with
the reference (tested against the demo goldens).
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from topsicle_tpu import aggregate, plots
from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.io import batch as batching
from topsicle_tpu.io import reader, writer
from topsicle_tpu.kmers import patterns_to_search
from topsicle_tpu.oracle.reference import ReadResult


@dataclasses.dataclass
class _Passer:
    order: int
    read_id: str
    kmer: str
    tail: str
    trc: float
    tail_codes: np.ndarray       # step-2 scan slice (already oriented)
    seq_len: int
    clean: bool = True           # tail is pure ACGT (lean wire eligible);
                                 # precomputed so global mode's lockstep
                                 # control word needs no batch assembly


class JaxEngine:
    """Single-host engine; multi-chip sharding is layered on by
    parallel.sharding.ShardedModel when more than one device is
    visible."""

    def __init__(self, cfg: TopsicleConfig, log: Optional[writer.RunLog] = None):
        import threading

        from topsicle_tpu.io import blockcache

        cfg.validate()
        self.cfg = cfg
        self.log = log or writer.RunLog(cfg.output_dir if cfg.output_dir else None, echo=False)
        self._models: Dict[int, object] = {}
        # Encoded-block cache: multi-telophrase runs parse each input
        # once and replay engine-native blocks for later phrases
        # (io/blockcache.py; the reference re-reads per k, main.py:206)
        self._bc_lock = threading.Lock()
        self._bc_enabled = (len(cfg.telophrases()) > 1
                            and blockcache.cache_budget_bytes() > 0)
        self._bc_left = blockcache.cache_budget_bytes() if self._bc_enabled else 0
        self._bc_write = self._bc_enabled   # run() clears this for the
                                            # final phrase (nothing would
                                            # ever read those entries)
        self._bc_skip: set = set()          # files that exhausted the budget
        # Device batch size (cfg.batch_size rounded up to a mesh
        # multiple when >1 device is visible), set by _model.  Kept
        # engine-local: cfg stays immutable under the caller — bench.py
        # holds one engine across runs, and a config object changing as
        # a side effect invites aliasing bugs.
        self._device_batch: Optional[int] = None

    @property
    def _B(self) -> int:
        """The engine's device batch size (>= cfg.batch_size; parse
        blocks stay cfg.batch_size-sized and pad up to this)."""
        return self._device_batch or self.cfg.batch_size

    def _bc_reserve(self, n: int) -> bool:
        with self._bc_lock:
            if self._bc_left >= n:
                self._bc_left -= n
                return True
            return False

    def _bc_refund(self, n: int) -> None:
        with self._bc_lock:
            self._bc_left += n

    # -- model cache -------------------------------------------------------
    def _model(self, phrase: int, kmers: Sequence[str]):
        if phrase not in self._models:
            import jax

            from topsicle_tpu.models import TelomereScanModel
            from topsicle_tpu.ops.match import MAX_ROLLING_K

            if phrase > MAX_ROLLING_K:
                # the reference's regex matcher has no k cap
                # (allsteps.py:182-183); phrases past the device
                # rolling-code capacity fall back to the host oracle
                # path for that phrase only, instead of erroring the run
                from topsicle_tpu.models.oracle_model import OracleScanModel

                self.log(
                    f"WARNING: telophrase {phrase} exceeds the device "
                    f"k-mer capacity ({MAX_ROLLING_K}); computing this "
                    "phrase on the host oracle path (slower)")
                self._models[phrase] = OracleScanModel(
                    kmers,
                    window_size=self.cfg.window_size,
                    slide=self.cfg.slide_value(),
                )
                return self._models[phrase]

            model = TelomereScanModel(
                kmers,
                window_size=self.cfg.window_size,
                slide=self.cfg.slide_value(),
            )
            # In files mode each process computes its own files on its
            # own chips: the shard mesh must span only ADDRESSABLE
            # devices (a global mesh would emit arrays this process
            # cannot fetch — the GSPMD global mesh belongs to
            # --shardMode global / GlobalScanModel).  Single-process
            # runs shard over everything visible, as before.
            devs = jax.local_devices() if jax.process_count() > 1 \
                else jax.devices()
            n_dev = len(devs)
            if n_dev > 1:
                from topsicle_tpu.parallel import ShardedScanModel, data_mesh

                # round the batch up to a mesh multiple so shards stay
                # equal — engine-locally (self._device_batch), never by
                # writing back into the user's config object
                B = self.cfg.batch_size
                if B % n_dev:
                    B += n_dev - B % n_dev
                self._device_batch = B
                model = ShardedScanModel(model, mesh=data_mesh(devices=devs))
            self._warmup(model)
            self._models[phrase] = model
        return self._models[phrase]

    def _warmup(self, model) -> None:
        """Dispatch dummy production-shaped batches through both device
        stages, asynchronously (no result sync), so that compiling (or
        loading from the persistent cache) the two programs overlaps the
        first file's host parse instead of stalling the first real
        batch.  Failures are ignored — the real launch surfaces them."""
        cfg = self.cfg
        B = self._B
        try:
            ends = np.zeros((B, 2, cfg.no_bp), np.uint8)     # all-'A', clean
            ends_len = np.full(B, cfg.no_bp, np.int32)
            futs = [model.step1_counts_launch(ends, ends_len)]
            L = cfg.static_scan_length()
            if L is not None:
                tails = np.zeros((B, L), np.uint8)
                lens = np.full(B, L, np.int32)
                nw = batching.window_counts_for_lengths(
                    lens, cfg.window_size, cfg.slide_value())
                futs.append(model.step2_boundary_launch(tails, nw, lens))
            # hold references so the dispatched computations aren't
            # dropped; the run's own batches queue behind them, so no
            # explicit sync is ever needed
            self._warm_futs = futs
        except Exception as e:
            # a permanently broken warmup would silently negate the
            # compile-overlap mitigation — keep it visible
            self.log(f"warmup dispatch failed ({type(e).__name__}: {e}); "
                     "first real batch will absorb compile time")

    # -- fleet warmup ------------------------------------------------------
    def precompile(self) -> int:
        """Compile every device program this configuration will use
        (both stages, both wire formats, the packed-API boundary used by
        extras runs, and the rawcounts programs when --plot/
        --rawcountpattern is set) into the persistent compilation cache
        (utils/compile_cache.py), and return the number of programs
        compiled or loaded.  Run once per machine image / cache volume
        (`topsicle --precompile ...`) so later job processes start warm.
        With --shardMode global the GSPMD programs are warmed too — run
        precompile with the same topology flags (--coordinator etc.) the
        jobs will use.  Caveat: with --scanLengthMode bucket, only the
        base quantum length is warmed (bucketed runs compile one program
        per observed length bucket).  No reference analog — the
        reference has no compile step."""
        from topsicle_tpu.utils.compile_cache import count_compiled_programs

        with count_compiled_programs() as compiled:
            self._precompile_all()
        return len(compiled)

    def _precompile_all(self) -> None:
        cfg = self.cfg
        for phrase in cfg.telophrases():
            kmers = patterns_to_search(cfg.pattern, phrase)
            model = self._model(phrase, kmers)
            if not hasattr(model, "pack_scan_batch"):
                continue    # host oracle fallback (k > device capacity)
            B = self._B
            ends = np.zeros((B, 2, cfg.no_bp), np.uint8)
            ends_len = np.full(B, cfg.no_bp, np.int32)
            np.asarray(model.step1_counts_launch(ends, ends_len))
            dirty = ends.copy()
            dirty[0, 0, 0] = 0xFF          # in-prefix invalid => dense wire
            np.asarray(model.step1_counts_launch(dirty, ends_len))
            L = cfg.static_scan_length() or cfg.length_bucket_quantum
            tails = np.zeros((B, L), np.uint8)
            lens = np.full(B, L, np.int32)
            nw = batching.window_counts_for_lengths(
                lens, cfg.window_size, cfg.slide_value())
            # the production launch...
            model.step2_boundary(tails, nw, lens)
            dt = tails.copy()
            dt[0, 0] = 0xFF
            model.step2_boundary(dt, nw, lens)
            # ...AND the packed-API boundary, which extras-enabled runs
            # use (the same programs, launched on pre-packed arrays)
            for x in model.step2_boundary_launch_packed(
                    model.pack_scan_batch(tails, lens), nw):
                np.asarray(x)
            for x in model.step2_boundary_launch_packed(
                    model.pack_scan_batch(dt, lens), nw):
                np.asarray(x)
            if cfg.rawcountpattern or cfg.plot:
                np.asarray(model.rawcounts_launch_packed(
                    model.pack_scan_batch(tails, lens)))
                np.asarray(model.rawcounts_launch_packed(
                    model.pack_scan_batch(dt, lens)))
            if cfg.shard_mode == "global":
                # the GSPMD global-batch programs are distinct from the
                # single-chip/shard_map ones; warm them with the same
                # topology the jobs will use (multi-process pods run
                # --precompile on every process simultaneously, like
                # the jobs themselves)
                import jax

                from topsicle_tpu.models.telomere import TelomereScanModel
                from topsicle_tpu.parallel.multihost import GlobalScanModel

                n_local = len(jax.local_devices())
                Bg = cfg.batch_size
                if Bg % n_local:
                    Bg += n_local - Bg % n_local
                gm = GlobalScanModel(TelomereScanModel(
                    kmers, window_size=cfg.window_size,
                    slide=cfg.slide_value()))
                ge = np.zeros((Bg, 2, cfg.no_bp), np.uint8)
                gel = np.full(Bg, cfg.no_bp, np.int32)
                np.asarray(gm.step1_counts_global_launch(ge, gel, dense=False))
                gdirty = ge.copy()
                gdirty[0, 0, 0] = 0xFF
                np.asarray(gm.step1_counts_global_launch(gdirty, gel, dense=True))
                Lg = cfg.static_scan_length()
                if Lg is None:       # same fallback as _run_phrase_global
                    q = cfg.length_bucket_quantum
                    span = max(1, cfg.maxlengthtelo - cfg.trimfirst)
                    Lg = max(q, -(-span // q) * q)
                gt = np.zeros((Bg, Lg), np.uint8)
                gl = np.full(Bg, Lg, np.int32)
                gnw = batching.window_counts_for_lengths(
                    gl, cfg.window_size, cfg.slide_value())
                for x in gm.step2_boundary_global_launch(gt, gnw, gl,
                                                         dense=False):
                    np.asarray(x)
                gt2 = gt.copy()
                gt2[0, 0] = 0xFF
                for x in gm.step2_boundary_global_launch(gt2, gnw, gl,
                                                         dense=True):
                    np.asarray(x)
            self.log(f"precompile: k={phrase} programs ready")

    # -- step 1 ------------------------------------------------------------
    def _select_hits(self, counts: np.ndarray, cutoff: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Host-side f64 TRC selection from device counts [B, 2, K],
        fully vectorized (no per-read Python loop): per-end argmax
        (numpy argmax = first-of-equals in table order, matching Python
        max(), allsteps.py:190-193), forward only on strict '>', keep on
        strict TRC > cutoff.  Returns (keep [B] bool, kmer_idx [B],
        is_forward [B] bool, trc [B] f64)."""
        ratio = self.cfg.no_bp / len(self.cfg.pattern)
        js = np.argmax(counts[:, 0, :], axis=1)
        je = np.argmax(counts[:, 1, :], axis=1)
        b = np.arange(counts.shape[0])
        trc_s = counts[b, 0, js].astype(np.float64) / ratio
        trc_e = counts[b, 1, je].astype(np.float64) / ratio
        fwd = trc_s > trc_e
        trc = np.where(fwd, trc_s, trc_e)
        sel_j = np.where(fwd, js, je)
        return trc > cutoff, sel_j, fwd, trc

    def _use_native(self) -> bool:
        if self.cfg.native_io is False:
            return False
        try:
            from topsicle_tpu.native import native_available
        except Exception:
            return False
        ok = native_available()
        if self.cfg.native_io is True and not ok:
            raise RuntimeError("native_io requested but the C++ IO library is unavailable")
        return ok

    def _iter_blocks(self, path: str):
        """Blocks of up to batch_size eligible reads, with the
        encoded-block cache wrapped around the raw parse: a
        multi-phrase run's later phrases replay the first parse's
        blocks from disk (~10x faster than re-inflating), and the
        cache entry only becomes visible after a COMPLETE successful
        parse (a failed file caches nothing)."""
        from topsicle_tpu.io import blockcache
        from topsicle_tpu.native.loader import Block

        cfg = self.cfg
        if self._bc_enabled:
            cached = blockcache.open_cached_blocks(
                cfg.output_dir, path, cfg.min_seq_length, cfg.batch_size)
            if cached is not None:
                try:
                    for ids, codes, offs in cached:
                        yield Block(ids, codes, offs)
                    return
                except Exception as e:
                    # an entry corrupted/truncated after commit must not
                    # kill the run NOR poison the retry: drop it (and
                    # refund its kept budget reservation), fail the unit
                    # like any unreadable input (resume re-parses fresh)
                    self._bc_refund(
                        blockcache.drop_entry(cfg.output_dir, path))
                    raise reader.InputFileError(path, e) from e
        bc = None
        # the _bc_left read is an unlocked fast-path gate (exactness is
        # enforced by the per-record reservation): once the budget is
        # gone, new files skip writer construction and the per-block
        # pickling entirely
        if (self._bc_write and path not in self._bc_skip
                and self._bc_left > 0):
            bc = blockcache.BlockCacheWriter(
                cfg.output_dir, path, cfg.min_seq_length, cfg.batch_size,
                self._bc_reserve, self._bc_refund)
        try:
            for blk in self._parse_blocks(path):
                if bc is not None and bc.active:
                    bc.add(blk.ids, blk.codes, blk.offs)
                yield blk
            if bc is not None:
                if bc.commit() == 0:
                    # budget exhausted (or IO failure): do not retry
                    # this file's cache in later phrases
                    self._bc_skip.add(path)
                bc = None
        finally:
            if bc is not None:   # error or abandoned generator
                bc.abandon()

    def _parse_blocks(self, path: str):
        """Raw parse: blocks of up to batch_size eligible reads (len >
        minSeqLength) — one flat code array + offsets per block, via the
        C++ loader when available (gzip inflate + parse + encode in one
        native pass), else the pure-Python reader.  Block granularity
        keeps the host path vectorized end-to-end (no per-read slice/
        copy/queue work).  Read-level failures (truncated gzip,
        malformed records) surface as InputFileError so the run can skip
        the file instead of dying."""
        from topsicle_tpu.native.loader import Block

        cfg = self.cfg
        Bblk = cfg.batch_size
        try:
            if self._use_native():
                from topsicle_tpu.native import NativeReader

                rd = NativeReader(path, cfg.min_seq_length, batch_reads=Bblk)
                try:
                    yield from rd.iter_blocks()
                finally:
                    rd.close()
                return
            ids: List[str] = []
            chunks: List[np.ndarray] = []
            offs = [0]
            for rec in reader.parse_records(path):
                if len(rec.seq) > cfg.min_seq_length:
                    c = batching.encode_read(rec.seq)
                    ids.append(rec.id)
                    chunks.append(c)
                    offs.append(offs[-1] + len(c))
                    if len(ids) >= Bblk:
                        yield Block(ids, np.concatenate(chunks),
                                    np.asarray(offs, np.int64))
                        ids, chunks, offs = [], [], [0]
            if ids:
                yield Block(ids, np.concatenate(chunks),
                            np.asarray(offs, np.int64))
        except (OSError, EOFError, UnicodeDecodeError, ValueError, MemoryError,
                zlib.error) as e:
            raise reader.InputFileError(path, e) from e

    def _read_source(self, path: str):
        """Eager background parse/encode of one file, bounded by ~2
        blocks (= ~2 device batches) of reads (utils.prefetch.Prefetcher
        starts immediately, so sources created ahead overlap the current
        file's device work — the reference's --threads fan-out, as a
        reader pool)."""
        from topsicle_tpu.utils.prefetch import Prefetcher

        return Prefetcher(self._iter_blocks(path), depth=2)

    def _step1_stream(self, path: str, kmers: Sequence[str], model,
                      source=None, timers=None):
        """Streaming step 1: a generator of _Passer in input order, with
        batches kept in flight — the device computes block i while the
        host parses/encodes block i+1.  One block = one device batch;
        ends assembly and TRC selection are vectorized over the whole
        block (no per-read host loop on the hot path — only passing
        reads touch Python, for tail slicing).  Yielding (instead of
        round 3's materialized list) lets the caller pipeline step 2
        behind step 1 with O(batch) peak memory: a monolithic
        whole-genome file no longer accumulates every passing read's
        tail slice (~20 kB each) before the first boundary runs."""
        import contextlib

        cfg = self.cfg
        cutoff = cfg.min_cutoff()
        B = self._B
        depth = 2
        pending = []  # [(order0, block, device_counts)]
        stage = (lambda: timers.stage("step1")) if timers is not None \
            else contextlib.nullcontext

        def drain_one():
            order0, blk, fut = pending.pop(0)
            counts = np.asarray(fut)[: len(blk)]
            keep, sel_j, fwd, trc = self._select_hits(counts, cutoff)
            offs = blk.offs
            out = []
            for i in np.nonzero(keep)[0]:
                i = int(i)
                codes = blk.codes[offs[i]:offs[i + 1]]
                tail = "forward" if fwd[i] else "reverse"
                out.append(
                    _Passer(
                        order0 + i, blk.ids[i], kmers[int(sel_j[i])], tail,
                        float(trc[i]),
                        # .copy(): drop the reference into the block's
                        # flat buffer so non-passing reads are freed
                        batching.extract_tail(
                            codes, tail, cfg.trimfirst, cfg.maxlengthtelo
                        ).copy(),
                        int(offs[i + 1] - offs[i]),
                    )
                )
            return out

        # parse/encode ahead on a reader thread (bounded by ~2 blocks)
        if source is None:
            source = self._read_source(path)
        order = 0
        for blk in source:
            with stage():
                n = len(blk)
                ends, ends_len_blk = batching.ends_batch_flat(
                    blk.codes, blk.offs, cfg.no_bp)
                ends_len = np.zeros(B, np.int32)
                ends_len[:n] = ends_len_blk
                if n < B:  # pad to the static batch shape
                    pad = np.full((B - n, 2, cfg.no_bp), 0xFF, np.uint8)
                    ends = np.concatenate([ends, pad], axis=0)
                pending.append(
                    (order, blk, model.step1_counts_launch(ends, ends_len)))
                order += n
                drained = drain_one() if len(pending) > depth else []
            yield from drained
        while pending:
            with stage():
                drained = drain_one()
            yield from drained

    def _step1_file(self, path: str, kmers: Sequence[str], model,
                    source=None) -> List[_Passer]:
        """Materialized _step1_stream (the --read_check debug path and
        the benchmarks use this form)."""
        return list(self._step1_stream(path, kmers, model, source=source))

    # -- subset emission ---------------------------------------------------
    def _write_subset(self, path: str, hit_ids: set) -> None:
        cfg = self.cfg
        out_path = writer.subset_path(cfg.output_dir, path, cfg.min_cutoff())
        if os.path.exists(out_path):
            self.log(f"Temporary fasta file already exists: {out_path}. Using existing file.")
            return
        fmt = reader.extension_format(path)
        # write to a temp name + atomic rename: a failed/killed write must
        # not leave a truncated subset that a later k / --resume would
        # silently reuse as complete (the exists-check above)
        tmp_path = out_path + ".tmp"
        try:
            if self._use_native():
                from topsicle_tpu.native import write_subset_native

                write_subset_native(path, tmp_path, sorted(hit_ids), fmt == "fastq")
            else:
                with open(tmp_path, "w") as fh:
                    for rec in reader.parse_records(path):
                        if rec.id in hit_ids:
                            writer.write_record(fh, rec, fmt)
            os.replace(tmp_path, out_path)
        except (OSError, EOFError, UnicodeDecodeError, ValueError, zlib.error) as e:
            if os.path.exists(tmp_path):
                try:
                    os.remove(tmp_path)
                except OSError:
                    pass
            raise reader.InputFileError(path, e) from e
        self.log(f"Temporary fasta file with TRC more than {cfg.min_cutoff()}:", out_path)

    # -- step 2 ------------------------------------------------------------
    def _step2_batches(self, passers, model, timers=None):
        """Consume an iterable of _Passer (list OR the _step1_stream
        generator) and yield (sub-list of passers, boundaries,
        (raw_future, n_windows) or None) in order, keeping up to 2
        device batches in flight ahead of the consumer.  With a
        generator input, step-2 batches launch while step 1 is still
        scanning later blocks — the two stages overlap on device and
        peak host memory stays O(batch).

        When per-read extras are wanted (--plot/--rawcountpattern) and
        the model supports the shared-pack API, the rawcounts program
        launches on the SAME packed wire arrays as the boundary — one
        host pack, lean wire when clean, and the [B, K, W] tensor
        pipelines with everything else instead of a packed-again
        synchronous re-run per batch."""
        import contextlib
        import itertools

        cfg = self.cfg
        B = self._B
        depth = 2
        stage = (lambda: timers.stage("step2")) if timers is not None \
            else contextlib.nullcontext
        want_extras = (cfg.plot or cfg.rawcountpattern) and \
            hasattr(model, "pack_scan_batch")

        def launch(group):
            # "static" scan mode pads every batch to one L so the whole
            # run uses ONE compiled step-2 program
            pad_len = cfg.static_scan_length() or max(
                len(p.tail_codes) for p in group)
            codes, lens = batching.tails_batch(
                [p.tail_codes for p in group], pad_len, cfg.length_bucket_quantum
            )
            if len(group) < B:
                pad = np.full((B - len(group), codes.shape[1]), 0xFF, np.uint8)
                codes = np.concatenate([codes, pad], axis=0)
                lens = np.concatenate([lens, np.zeros(B - len(group), np.int32)])
            n_windows = batching.window_counts_for_lengths(lens, cfg.window_size, cfg.slide_value())
            if want_extras:
                # pack once; both programs ride the same device arrays
                packed = model.pack_scan_batch(codes, lens)
                fut = model.step2_boundary_launch_packed(packed, n_windows)
                raw = model.rawcounts_launch_packed(packed)
                return fut, (raw, n_windows)
            return model.step2_boundary_launch(codes, n_windows, lens), None

        def consume(group, fut, extras):
            t, has = (np.asarray(x) for x in fut)
            bounds = []
            for j, p in enumerate(group):
                maxc = min(cfg.maxlengthtelo, p.seq_len)
                b = int(cfg.trimfirst + cfg.slide_value() * int(t[j])) if has[j] else 0
                if b == 0 or b > maxc:
                    b = 0
                bounds.append(b)
            return group, bounds, extras

        it = iter(passers)
        inflight = []
        while True:
            # pulling the next group advances _step1_stream (its time
            # lands in the step1 stage, not here)
            group = list(itertools.islice(it, B))
            if group:
                with stage():
                    inflight.append((group, *launch(group)))
            if (group and len(inflight) > depth) or (not group and inflight):
                g, f, e = inflight.pop(0)
                with stage():      # the device wait; row emission happens
                    res = consume(g, f, e)     # in the consumer, unstaged
                yield res
            if not group and not inflight:
                return

    # -- optional per-read outputs (--plot / --rawcountpattern) ------------
    def _per_read_extras(self, group: List[_Passer], model, phrase: int,
                         bounds: List[int], image_start: int,
                         extras=None) -> None:
        """`extras` is the (raw_future, n_windows) pair pre-launched by
        _step2_batches on the boundary batch's own packed arrays; when
        None (global-mode rebatching, oracle-model fallback) the batch
        is packed here — once, lean when clean — and launched fresh."""
        cfg = self.cfg
        if not (cfg.plot or cfg.rawcountpattern):
            return
        if extras is None:
            B = self._B
            pad_len = cfg.static_scan_length() or max(len(p.tail_codes) for p in group)
            codes, lens = batching.tails_batch(
                [p.tail_codes for p in group], pad_len, cfg.length_bucket_quantum
            )
            if len(group) < B:
                pad = np.full((B - len(group), codes.shape[1]), 0xFF, np.uint8)
                codes = np.concatenate([codes, pad], axis=0)
                lens = np.concatenate([lens, np.zeros(B - len(group), np.int32)])
            n_windows = batching.window_counts_for_lengths(
                lens, cfg.window_size, cfg.slide_value())
            if hasattr(model, "pack_scan_batch"):
                raw_fut = model.rawcounts_launch_packed(
                    model.pack_scan_batch(codes, lens))
            else:
                raw_fut = model.rawcounts(codes)   # host oracle model
        else:
            raw_fut, n_windows = extras
        raw = np.asarray(raw_fut)             # [B, K, W]
        for j, p in enumerate(group):
            num = image_start + j
            nw = int(n_windows[j])
            counts = np.maximum(raw[j, :, :nw], 1)     # or-1 floor
            if cfg.rawcountpattern:
                self._write_rawcount(p, model, counts, phrase, num)
            if cfg.plot and plots.matplotlib_available():
                starts = np.arange(nw) * cfg.slide_value() + cfg.trimfirst
                means = counts.sum(axis=0) / counts.shape[0]
                out = os.path.join(cfg.output_dir, f"plot_{phrase}_{num}.png")
                plots.changepoint_plot(
                    starts, means, bounds[j], p.read_id, out,
                    xlim=cfg.rangecp or min(cfg.maxlengthtelo, p.seq_len),
                )

    def _remove_unit_extras(self, phrase: int, image_end: int) -> None:
        """Delete the per-read extras files (rawcount CSVs / plot PNGs)
        a failed unit already emitted, numbers 1..image_end-1: a skipped
        unit must contribute nothing (PARITY.md deviation 7), and the
        streamed pipeline writes extras before the unit is known to
        complete."""
        cfg = self.cfg
        if not (cfg.plot or cfg.rawcountpattern):
            return
        for n in range(1, image_end):
            for name in (f"rawcount_{phrase}_{n}.csv", f"plot_{phrase}_{n}.png"):
                try:
                    os.remove(os.path.join(cfg.output_dir, name))
                except OSError:
                    pass

    def _write_rawcount(self, p: _Passer, model, counts: np.ndarray,
                        phrase: int, num: int) -> None:
        """rawcount_{phrase}_{num}.csv — rows (tail, window start,
        kmer, count-or-1), window-major, unlabeled index column
        (allsteps.py:359-464).  Byte-identical to the reference's
        pandas.to_csv (main.py:146-150): LF line endings (the committed
        demo artifact's — csv.writer's default CRLF diverged), header
        row with an empty index label, minimal quoting.  A 20 kb read
        emits ~40k rows, so rows go to csv.writerows in one call."""
        import csv
        import itertools

        path = os.path.join(self.cfg.output_dir, f"rawcount_{phrase}_{num}.csv")
        K, nw = counts.shape
        n = K * nw
        positions = np.repeat(np.arange(nw) * self.cfg.slide_value(), K)
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh, lineterminator="\n")
            w.writerow(["", "tail", "position", "pattern", "count"])
            w.writerows(zip(range(n), itertools.repeat(p.tail, n),
                            positions.tolist(), list(model.kmers) * nw,
                            counts.T.reshape(-1).tolist()))

    # -- global-mesh mode (--shardMode global) -----------------------------
    def _run_phrase_global(self, phrase: int, kmers: Sequence[str],
                           local_files, timers):
        """One telophrase in global-batch mode: every process contributes
        a B_local shard of each global batch; GSPMD spreads the scan over
        ALL chips of all hosts; results come back replicated and each
        process keeps rows for reads it contributed.  Lockstep is held by
        a per-iteration OR-allgathered control word (see the unified
        scheduler below) — hosts whose streams run dry keep feeding
        empty shards until every stream and buffer is dry.  Per-read
        extras (--plot / --rawcountpattern) run locally per owned file,
        numbered in row order like files mode.
        Returns ({file_idx: (label, [row, ...], [trc, ...], [telo, ...])},
        failed_file_idxs) for this process; failed files (unreadable
        input, subset write error) carry no rows and must stay un-done so
        --resume retries them (same semantics as files mode)."""
        import jax

        from topsicle_tpu.models.telomere import TelomereScanModel, _batch_is_clean
        from topsicle_tpu.parallel.multihost import (
            GlobalScanModel, or_across_processes)

        cfg = self.cfg
        cutoff = cfg.min_cutoff()
        n_local_dev = len(jax.local_devices())
        B_local = cfg.batch_size
        if B_local % n_local_dev:
            B_local += n_local_dev - B_local % n_local_dev
        base = TelomereScanModel(
            kmers, window_size=cfg.window_size, slide=cfg.slide_value())
        gmodel = GlobalScanModel(base)

        # Lockstep requires identical global shapes on every process and
        # one compile for the whole run, so global mode always pads to
        # the static scan length; "bucket" mode cannot be honored here.
        L_static = cfg.static_scan_length()
        if L_static is None:
            self.log("shardMode=global requires one static scan length; "
                     "--scanLengthMode bucket is not honored in this mode")
            q = cfg.length_bucket_quantum
            span = max(1, cfg.maxlengthtelo - cfg.trimfirst)
            L_static = max(q, -(-span // q) * q)

        failed: set = set()

        def stream_blocks():
            """Per-block stream with ends assembly vectorized once per
            block (io.batch.ends_batch_flat), matching files mode's
            flat path (_step1_file) — global mode previously rebuilt
            every batch read-by-read on the host, which on a real pod
            would fall behind its own device side."""
            for file_idx, path in local_files:
                try:
                    src = self._read_source(path)
                    try:
                        order = 0
                        for blk in src:
                            ends, elen = batching.ends_batch_flat(
                                blk.codes, blk.offs, cfg.no_bp)
                            yield (file_idx, path, order, blk, ends, elen)
                            order += len(blk)
                    finally:
                        src.close()
                except reader.InputFileError as e:
                    failed.add(file_idx)
                    self.log(f"ERROR: {e}; skipping this file")

        # ---- unified lockstep scheduler (round 4) ------------------------
        # Step-1 and step-2 global batches interleave in ONE loop.  Each
        # iteration every process computes the same 5-bit OR-allgathered
        # control word
        #     [s1_has, s1_dense, s2_full, s2_live, s2_dense]
        # and derives the same schedule:
        #     s1_go = s1_has anywhere
        #     s2_go = a full passer batch anywhere, OR (no step-1 data
        #             anywhere AND passers/in-flight work somewhere —
        #             the drain-out phase)
        # so all processes launch the identical sequence of global
        # programs (lockstep preserved).  When a process's stream dries
        # it drains its last in-flight step-1 batch BEFORE computing
        # the word (there is no host parse work left to overlap), so
        # s2_live is exact: the final batch's passers cannot be
        # stranded past an agreed stop, and a zero-hit phrase never
        # launches an all-pad step-2 program.  vs round 3's two
        # sequential phases: boundary batches now run while step 1 is
        # still scanning (stage overlap on the mesh) and the passers
        # buffer stays bounded (~2 B_local + one parse block) instead
        # of holding every passing tail of this process's file share.
        # Subsets (which need a file's full hit set) are written after
        # the loop; their failure still fails the unit.
        it = stream_blocks()
        pbuf: List[Tuple[int, str, _Passer]] = []   # FIFO passers buffer
        exhausted = False
        cur = None      # partially consumed block: [meta..., ends, elen, pos]
        hit_ids: Dict[int, set] = {}   # file_idx -> passing read ids
        rows: Dict[int, tuple] = {}    # file_idx -> (label, rows, trcs, telos)
        extras: Dict[int, list] = {}   # file_idx -> [(passer, bound), ...]
        want_extras = cfg.plot or cfg.rawcountpattern

        def drain_step1(buf, fut):
            """buf rows are (file_idx, path, order, read_id, block,
            index-in-block); only keepers touch Python slicing."""
            mine = gmodel.my_rows(np.asarray(fut), B_local)[: len(buf)]
            if not len(buf):
                return
            keep, sel_j, fwd, trc = self._select_hits(mine, cutoff)
            for i in np.nonzero(keep)[0]:
                i = int(i)
                file_idx, path, order, rid, blk, bi = buf[i]
                codes = blk.codes[blk.offs[bi]:blk.offs[bi + 1]]
                tail = "forward" if fwd[i] else "reverse"
                tail_codes = batching.extract_tail(
                    codes, tail, cfg.trimfirst, cfg.maxlengthtelo
                ).copy()    # .copy(): codes is a view into the block buffer
                hit_ids.setdefault(file_idx, set()).add(rid)
                pbuf.append((file_idx, path, _Passer(
                    order, rid, kmers[int(sel_j[i])], tail, float(trc[i]),
                    tail_codes, len(codes),
                    clean=bool((tail_codes < 4).all()),
                )))

        extras_done: Dict[int, int] = {}   # file_idx -> next image number

        def flush_extras(f):
            """Per-read extras for file f, chunked like files mode
            (image numbers 1..n in row order); flushing as soon as a
            file completes keeps its tails from staying resident for
            the whole phrase.  Failed files write nothing."""
            pairs = extras.pop(f, [])
            if not pairs:
                return
            if f in failed:
                for p, _ in pairs:
                    p.tail_codes = None
                return
            Bc = cfg.batch_size
            image_num = extras_done.get(f, 1)
            for s in range(0, len(pairs), Bc):
                chunk = pairs[s:s + Bc]
                self._per_read_extras([p for p, _ in chunk], base, phrase,
                                      [b for _, b in chunk], image_num)
                image_num += len(chunk)
            extras_done[f] = image_num
            for p, _ in pairs:
                p.tail_codes = None

        def drain_step2(group, fut):
            t, has = (np.asarray(x) for x in fut)
            t_mine = gmodel.my_rows(t, B_local)
            has_mine = gmodel.my_rows(has, B_local)
            for j, (file_idx, path, p) in enumerate(group):
                maxc = min(cfg.maxlengthtelo, p.seq_len)
                b = int(cfg.trimfirst + cfg.slide_value() * int(t_mine[j])) \
                    if has_mine[j] else 0
                if b == 0 or b > maxc:
                    b = 0
                lbl = writer.file_label(path)
                entry = rows.setdefault(file_idx, (lbl, [], [], []))
                entry[1].append([lbl, phrase, f"{p.trc:.3f}", p.read_id, b])
                entry[2].append(float(p.trc))      # full precision for quadfit
                entry[3].append(float(b))
                if want_extras:
                    extras.setdefault(file_idx, []).append((p, b))
                else:
                    p.tail_codes = None
                timers.count(reads=1, bases=p.seq_len)
            if want_extras and group:
                # passers drain in stream order, so any file below the
                # newest one seen is complete — flush its extras now
                maxf = max(fi for fi, _, _ in group)
                for f in [f for f in list(extras) if f < maxf]:
                    flush_extras(f)

        def assemble_step1():
            """One global shard from block-granularity pieces: the ends
            rows were built vectorized at block parse time, so batch
            assembly is a couple of row-slab concatenates."""
            nonlocal cur, exhausted
            buf = []
            pieces_e: List[np.ndarray] = []
            pieces_l: List[np.ndarray] = []
            while len(buf) < B_local and not exhausted:
                if cur is None:
                    try:
                        file_idx, path, order, blk, ends_blk, elen_blk = next(it)
                        cur = [file_idx, path, order, blk, ends_blk, elen_blk, 0]
                    except StopIteration:
                        exhausted = True
                        break
                file_idx, path, order, blk, ends_blk, elen_blk, pos = cur
                take = min(B_local - len(buf), len(blk) - pos)
                pieces_e.append(ends_blk[pos:pos + take])
                pieces_l.append(elen_blk[pos:pos + take])
                for j in range(pos, pos + take):
                    buf.append((file_idx, path, order + j, blk.ids[j], blk, j))
                cur[6] = pos + take
                if cur[6] >= len(blk):
                    cur = None
            n = len(buf)
            ends = np.full((B_local, 2, cfg.no_bp), 0xFF, np.uint8)
            ends_len = np.zeros(B_local, np.int32)
            if n:
                ends[:n] = np.concatenate(pieces_e, axis=0)
                ends_len[:n] = np.concatenate(pieces_l)
            return buf, ends, ends_len

        def launch_step2(group, dense):
            codes, lens = batching.tails_batch(
                [p.tail_codes for _, _, p in group], L_static,
                cfg.length_bucket_quantum)
            if codes.shape[1] != L_static:   # batch shorter than static L
                padc = np.full((codes.shape[0], L_static - codes.shape[1]),
                               0xFF, np.uint8)
                codes = np.concatenate([codes, padc], axis=1)
            if len(group) < B_local:
                pad = np.full((B_local - len(group), L_static), 0xFF, np.uint8)
                codes = np.concatenate([codes, pad], axis=0) if len(group) else \
                    np.full((B_local, L_static), 0xFF, np.uint8)
                lens = np.concatenate(
                    [lens, np.zeros(B_local - len(lens), np.int32)]) if len(group) \
                    else np.zeros(B_local, np.int32)
            n_windows = batching.window_counts_for_lengths(
                lens, cfg.window_size, cfg.slide_value())
            return gmodel.step2_boundary_global_launch(
                codes, n_windows, lens, dense=dense)

        prev1 = None    # (buf, in-flight device counts)
        prev2 = None    # (group, in-flight device (t, has))
        while True:
            buf, ends, ends_len = assemble_step1()
            n1 = len(buf)
            if n1 == 0 and prev1 is not None:
                # my stream just dried: there is no step-1 host work
                # left to overlap, so drain the in-flight batch BEFORE
                # the control word — s2_live then reflects the true
                # buffer and a zero-hit phrase never launches an
                # all-pad step-2 program (and the last batch's passers
                # cannot be stranded past the agreed stop)
                drain_step1(*prev1)
                prev1 = None
            s1_clean = _batch_is_clean(
                ends.reshape(B_local * 2, -1), np.repeat(ends_len, 2))
            group = pbuf[:B_local]
            s2_clean = all(p.clean for _, _, p in group)
            word = or_across_processes(np.array([
                n1 > 0, not s1_clean,
                len(pbuf) >= B_local, bool(pbuf), not s2_clean,
            ]))
            s1_go = bool(word[0])
            s2_go = bool(word[2]) or (not s1_go and bool(word[3]))
            fut1 = gmodel.step1_counts_global_launch(
                ends, ends_len, dense=bool(word[1])) if s1_go else None
            fut2 = None
            if s2_go:
                del pbuf[: len(group)]
                fut2 = launch_step2(group, dense=bool(word[4]))
            if prev1 is not None:
                drain_step1(*prev1)
            prev1 = (buf, fut1) if fut1 is not None else None
            if prev2 is not None:
                drain_step2(*prev2)
            prev2 = (group, fut2) if fut2 is not None else None
            if not s1_go and not s2_go and prev1 is None and prev2 is None:
                break

        # flush extras of the final files (everything earlier flushed
        # inline as files completed); failed files write nothing.  This
        # runs BEFORE the subset writes so a subset failure can still
        # remove the unit's flushed extras.
        if want_extras:
            for file_idx in sorted(list(extras)):
                flush_extras(file_idx)

        # subset files (resume artifact) for this process's files
        for file_idx, path in local_files:
            if file_idx in failed:
                continue
            try:
                self._write_subset(path, hit_ids.get(file_idx, set()))
            except reader.InputFileError as e:
                # the subset is the resume artifact: treat its failure
                # like files mode does (unit stays un-done, rows dropped
                # by the caller, which skips failed file idxs); extras
                # the unit already flushed are removed
                failed.add(file_idx)
                self.log(f"ERROR: {e}; subset not written")
                self._remove_unit_extras(phrase, extras_done.get(file_idx, 1))
        return rows, failed

    def _emit_kept_unit(self, csv_path: str, lbl: str, phrase: int, path: str,
                        manifest, kept_rows: Dict[tuple, List[tuple]],
                        results: List[ReadResult],
                        phrase_to_telo: Dict[int, List[float]],
                        phrase_to_trc: Dict[int, List[float]]) -> None:
        """Re-emit a resume-completed unit's rows at its canonical
        phrase x file position (original trc strings, full-precision
        manifest TRCs for the aggregates) so a resumed run's CSV and
        aggregate lists are byte-identical to an uninterrupted run's.
        Pops the unit from kept_rows so a second same-label file never
        re-writes it."""
        unit_rows = kept_rows.pop((lbl, phrase), [])
        full_trcs = manifest.trcs_for(path, phrase)
        if full_trcs is not None and len(full_trcs) != len(unit_rows):
            full_trcs = None    # stale manifest payload
        for i, (rid, trc, telo) in enumerate(unit_rows):
            writer.append_csv_row_raw(csv_path, [lbl, phrase, trc, rid, telo])
            ftrc = full_trcs[i] if full_trcs is not None else float(trc)
            results.append(ReadResult(lbl, phrase, rid, ftrc, telo))
            phrase_to_telo.setdefault(phrase, []).append(float(telo))
            phrase_to_trc.setdefault(phrase, []).append(ftrc)

    # -- resume support ----------------------------------------------------
    def _prepare_resume(self, csv_path: str):
        """Load the manifest + existing CSV; keep rows belonging to
        completed (file, phrase) units, drop rows of interrupted units
        (they will be recomputed).  Kept rows are NOT written here —
        the run loop re-emits each unit's rows at its canonical position
        in the phrase x file iteration, so a resumed run's CSV is
        byte-identical to an uninterrupted run's (SURVEY.md §7.2.6
        deterministic global ordering).  Returns (manifest, kept_rows)
        where kept_rows maps (label, phrase) -> [(read_id, trc_str,
        telo)] in original CSV order."""
        import csv as _csv

        from topsicle_tpu.utils import RunManifest

        manifest = RunManifest(self.cfg.output_dir)
        done_labels = set()
        for phrase in self.cfg.telophrases():
            for path in self.cfg.input_paths():
                if manifest.is_done(path, phrase):
                    done_labels.add((writer.file_label(path), phrase))
        kept: Dict[tuple, List[tuple]] = {}
        if os.path.exists(csv_path):
            with open(csv_path, newline="") as fh:
                rows = list(_csv.reader(fh))
            body = [r for r in rows[1:] if len(r) == 5]
            for lbl, ph, trc, rid, telo in body:
                key = (lbl, int(ph))
                if key in done_labels:
                    kept.setdefault(key, []).append((rid, trc, int(telo)))
        writer.write_csv_header(csv_path)
        return manifest, kept

    # -- full run ----------------------------------------------------------
    def run(self) -> List[ReadResult]:
        from topsicle_tpu.utils import StageTimers, trace_context

        from topsicle_tpu.parallel import distributed as dist_mod

        cfg = self.cfg
        timers = StageTimers()
        os.makedirs(cfg.output_dir, exist_ok=True)
        csv_path = os.path.join(cfg.output_dir, "telolengths_all.csv")
        self.log(f"Output will be here: {csv_path}")
        if self._use_native():
            self.log("reader: native C++")
        else:
            from topsicle_tpu.native import unavailable_reason

            why = unavailable_reason()
            self.log("reader: Python" + (f" (native IO unavailable: {why})"
                                         if why else ""))
        if cfg.plot and not plots.matplotlib_available():
            self.log(plots.SKIPPED)

        pid, nproc = dist_mod.process_identity(cfg.process_id, cfg.process_count)
        dist = nproc > 1
        if dist and (cfg.resume or cfg.read_check is not None):
            raise ValueError("distributed runs do not support resume or read_check")
        if cfg.shard_mode == "global":
            if cfg.read_check is not None:
                # read_check is a single-read debug path; spinning up a
                # lockstep global mesh across hosts for one read is never
                # what the user wants — files mode covers it.
                raise ValueError(
                    "shardMode=global does not support read_check "
                    "(use shardMode=files)"
                )
            if dist:
                import jax

                if jax.process_count() != nproc:
                    raise ValueError(
                        "shardMode=global needs jax.distributed across all "
                        f"processes (jax sees {jax.process_count()} process(es), "
                        f"--processCount says {nproc}); pass --coordinator"
                    )
        if dist:
            # drop this process's stale done-marker/parts from any
            # crashed earlier run before new work begins (ownership-
            # scoped: concurrent fresh processes are never touched)
            dist_mod.reset_mine(cfg.output_dir, pid, nproc)

        manifest = None
        kept_rows: Dict[tuple, List[tuple]] = {}
        if cfg.resume:
            manifest, kept_rows = self._prepare_resume(csv_path)
        elif (not dist or pid == 0) and os.path.exists(csv_path) and os.path.getsize(csv_path) > 0:
            if cfg.override:
                self.log(f"Output file {csv_path} already exists; overwriting it (--override given).")
                os.remove(csv_path)
            else:
                raise FileExistsError(
                    f"Output file {csv_path} already exists and is not empty. "
                    "Use --override to force overwrite."
                )
        if not cfg.resume and (not dist or pid == 0):
            writer.write_csv_header(csv_path)
            from topsicle_tpu.utils import RunManifest

            manifest = RunManifest(cfg.output_dir)
            manifest.reset()

        results: List[ReadResult] = []
        phrase_to_telo: Dict[int, List[float]] = {}
        phrase_to_trc: Dict[int, List[float]] = {}

        all_files = list(enumerate(cfg.input_paths()))
        local_files = [(i, f) for i, f in all_files if not dist or i % nproc == pid]

        if self._bc_enabled:
            from topsicle_tpu.io import blockcache as _bc

            # a fresh budget + skip set per run: engine reuse (bench
            # runs the same engine twice) must not start depleted by a
            # previous run's reservations, which the end-of-run clear
            # deletes without refunding
            self._bc_left = _bc.cache_budget_bytes()
            self._bc_skip.clear()
            if not cfg.resume and not dist:
                # fresh runs never replay a previous run's cache; also
                # cleans stale entries a crashed run left behind.  Dist
                # processes start unsynchronized, so a late starter
                # must NOT wipe peers' committed entries — dist relies
                # on the post-barrier clear (and mtime keys make stale
                # entries inert).
                _bc.clear(cfg.output_dir)
        phrases_all = cfg.telophrases()
        with trace_context(cfg.trace_dir):
            for phrase_i, phrase in enumerate(phrases_all):
                # the final phrase's parse output would never be read:
                # skip the cache writes (replay still applies).  By
                # INDEX, not value — telophrase lists may repeat.
                self._bc_write = (self._bc_enabled
                                  and phrase_i != len(phrases_all) - 1)
                kmers = patterns_to_search(cfg.pattern, phrase)
                self.log("patterns to search:", kmers)
                if cfg.shard_mode == "global":
                    self.log("begin processing reads (global mesh)")
                    todo = local_files
                    if cfg.resume:
                        todo = [(i, p) for i, p in local_files
                                if not manifest.is_done(p, phrase)]
                    rows_by_file, failed_files = self._run_phrase_global(
                        phrase, kmers, todo, timers)
                    # canonical file-index order: resume-completed units
                    # re-emit kept rows, computed units write + mark done
                    for file_idx, path in local_files:
                        lbl = writer.file_label(path)
                        if cfg.resume and manifest.is_done(path, phrase):
                            self.log(f"resume: skipping completed unit {path} (k={phrase})")
                            self._emit_kept_unit(csv_path, lbl, phrase, path,
                                                 manifest, kept_rows, results,
                                                 phrase_to_telo, phrase_to_trc)
                            continue
                        if file_idx in failed_files:
                            # no part, no rows, no mark_done: the unit
                            # stays un-done so --resume recomputes it
                            continue
                        _, rws, f_trcs, f_telos = rows_by_file.get(
                            file_idx, (lbl, [], [], []))
                        if dist:
                            dist_mod.write_part(cfg.output_dir, phrase,
                                                file_idx, rws, f_trcs, f_telos)
                        else:
                            for r in rws:
                                writer.append_csv_row(
                                    csv_path, r[0], r[1], float(r[2]), r[3], r[4])
                        for r, ft in zip(rws, f_trcs):
                            results.append(ReadResult(lbl, phrase, r[3], ft, r[4]))
                        phrase_to_trc.setdefault(phrase, []).extend(f_trcs)
                        phrase_to_telo.setdefault(phrase, []).extend(f_telos)
                        if manifest is not None and not dist and cfg.read_check is None:
                            manifest.mark_done(path, phrase, len(rws), trcs=f_trcs)
                    continue

                model = self._model(phrase, kmers)
                self.log("begin processing reads")
                # Cross-file read-ahead pool: while file i drives the
                # device, up to threads-1 bounded reader threads parse/
                # encode files i+1..i+threads-1 concurrently.  This is
                # the streamed shape of the reference's fork pool over
                # files (main.py:232-235): same worker count semantics,
                # but the device consumes files in order so the CSV is
                # byte-identical at any thread count (tested at 1/2/4).
                # --threads 1 = fully serial.
                ahead = max(0, cfg.threads_value() - 1)
                todo = [p for _, p in local_files
                        if not (cfg.resume and manifest.is_done(p, phrase))]
                todo_pos = {p: i for i, p in enumerate(todo)}
                sources: Dict[str, object] = {}

                def ensure_ahead(path):
                    j = todo_pos.get(path)
                    if j is None:
                        return
                    for q in todo[j + 1 : j + 1 + ahead]:
                        if q not in sources:
                            sources[q] = self._read_source(q)
                try:
                  for file_idx, path in local_files:
                    lbl = writer.file_label(path)
                    if cfg.resume and manifest.is_done(path, phrase):
                        self.log(f"resume: skipping completed unit {path} (k={phrase})")
                        self._emit_kept_unit(csv_path, lbl, phrase, path,
                                             manifest, kept_rows, results,
                                             phrase_to_telo, phrase_to_trc)
                        continue

                    src = sources.pop(path, None) or self._read_source(path)
                    ensure_ahead(path)

                    self.log("subsetting raw dataset based on TRC cutoff")
                    # Step 2 pipelines directly behind the step-1 stream
                    # (round 4): boundary batches launch while later
                    # blocks are still being scanned, and peak host
                    # memory is O(batch) instead of every passing tail
                    # of the file.  The unit's rows/aggregates buffer
                    # until the unit completes, so a mid-file failure
                    # still contributes nothing (PARITY.md deviation 7);
                    # the subset (which needs the full hit-id set) is
                    # written when the stream is exhausted.
                    hit_ids: List[str] = []
                    unit_rows: List[tuple] = []     # ReadResult + row args
                    image_num = 1
                    try:
                        if cfg.read_check is not None:
                            passers = self._step1_file(
                                path, kmers, model, source=src)
                            with timers.stage("subset"):
                                self._write_subset(
                                    path, {p.read_id for p in passers})
                            self.log("checking specific read:", cfg.read_check)
                            sel = [p for p in passers
                                   if p.read_id == cfg.read_check]
                            if not sel:
                                raise ValueError(
                                    f"read {cfg.read_check!r} did not pass the step-1 TRC filter "
                                    "(the reference crashes on this combination; refusing clearly)"
                                )
                            self.log("step 2 on:", cfg.read_check)
                            stream = iter(sel)
                            subset_pending = False
                        else:
                            def _tracked():
                                for p in self._step1_stream(
                                        path, kmers, model, source=src,
                                        timers=timers):
                                    hit_ids.append(p.read_id)
                                    yield p
                            stream = _tracked()
                            subset_pending = True

                        for group, bounds, extras in self._step2_batches(
                                stream, model, timers=timers):
                            self._per_read_extras(group, model, phrase,
                                                  bounds, image_num, extras)
                            image_num += len(group)
                            for p, b in zip(group, bounds):
                                # keep only the scalar fields: holding the
                                # _Passer (with its ~20 kB tail slice)
                                # until unit flush would put peak memory
                                # right back at O(file)
                                unit_rows.append(
                                    (p.read_id, p.trc, p.kmer, p.tail, b))
                                timers.count(reads=1, bases=p.seq_len)
                                p.tail_codes = None
                        if subset_pending:
                            with timers.stage("subset"):
                                self._write_subset(path, set(hit_ids))
                    except reader.InputFileError as e:
                        # One unreadable file must not kill a whole-genome
                        # run; its unit stays un-done (and emits nothing)
                        # so --resume retries it.  Extras files already
                        # written for this unit's early batches are
                        # removed so the unit truly contributes nothing.
                        self.log(f"ERROR: {e}; skipping this file")
                        self._remove_unit_extras(phrase, image_num)
                        continue
                    finally:
                        src.close()

                    part_rows: List[list] = []
                    unit_trcs: List[float] = []
                    for rid, trc, kmer, tail, b in unit_rows:
                        if dist:
                            part_rows.append(
                                [lbl, phrase, f"{trc:.3f}", rid, b]
                            )
                        else:
                            writer.append_csv_row(csv_path, lbl, phrase, trc, rid, b)
                        results.append(ReadResult(lbl, phrase, rid, trc, b, kmer, tail))
                        phrase_to_telo.setdefault(phrase, []).append(float(b))
                        phrase_to_trc.setdefault(phrase, []).append(float(trc))
                        unit_trcs.append(float(trc))
                    n_rows = len(unit_rows)
                    if dist:
                        dist_mod.write_part(
                            cfg.output_dir, phrase, file_idx, part_rows,
                            phrase_to_trc.get(phrase, [])[-n_rows:] if n_rows else [],
                            phrase_to_telo.get(phrase, [])[-n_rows:] if n_rows else [],
                        )
                    elif manifest is not None and cfg.read_check is None:
                        manifest.mark_done(path, phrase, n_rows, trcs=unit_trcs)
                finally:
                    # abandoned read-ahead sources (read_check abort, a
                    # raised error) must not leave workers blocked on
                    # full queues holding file handles
                    for s_ in sources.values():
                        s_.close()
                self.log("finished processing all reads")
        if self._bc_enabled and not dist:
            # dist: process 0 clears after the merge barrier instead —
            # clearing early would break slower processes' later phrases
            from topsicle_tpu.io import blockcache

            blockcache.clear(cfg.output_dir)
        self.log(timers.summary())

        if dist:
            dist_mod.mark_done(cfg.output_dir, pid, nproc)
            dist_mod.barrier()
            if pid != 0:
                return results
            run_parts = dist_mod.wait_all(cfg.output_dir, nproc)
            phrase_to_trc, phrase_to_telo = dist_mod.merge(
                cfg.output_dir, csv_path, run_parts
            )
            dist_mod.cleanup_parts(cfg.output_dir)
            if self._bc_enabled:
                from topsicle_tpu.io import blockcache

                blockcache.clear(cfg.output_dir)

        # The reference always saves the quadfit plot when >=3 points
        # (main.py:270-273) — not gated on --plot.
        def plot_factory(phrase):
            def fn(trc, telo, vx, vy, coeffs):
                try:
                    out = os.path.join(cfg.output_dir, f"quadfit_{phrase}mer_{cfg.pattern}.png")
                    plots.quadfit_plot(trc, telo, vx, vy, coeffs, out)
                except Exception as e:  # plotting must never kill a run
                    self.log(f"quadfit plot failed: {e}")
            return fn

        if not plots.matplotlib_available():
            plot_factory = None
            # one line per run: --plot runs said it at start
            if not cfg.plot and any(len(t) >= 3 for t in phrase_to_telo.values()):
                self.log(plots.SKIPPED)
        aggregate.summarize_all(
            phrase_to_trc, phrase_to_telo, cfg.input_trc(),
            log=self.log, plot_fn_for_phrase=plot_factory,
        )
        self.log("All telomere found, have a nice day.")
        return results


def make_engine(cfg: TopsicleConfig, log: Optional[writer.RunLog] = None):
    """Engine factory honoring cfg.engine ('jax' | 'oracle')."""
    if cfg.engine == "oracle":
        from topsicle_tpu.oracle import OracleEngine

        return OracleEngine(cfg, log=log)
    return JaxEngine(cfg, log=log)

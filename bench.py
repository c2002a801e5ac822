"""Benchmark: device scan throughput + end-to-end engine rate on a GPU.

Prints ONE JSON line:
  {"metric": "device_scan_throughput", "value": <Mbp/s>, "unit": "Mbp/s",
   "vs_baseline": <value / 0.4>, "platform": ..., "device_kind": ...,
   "device_count": ..., ...secondary fields...}

Baseline: the reference demo implies ~0.4 Mbp/s end-to-end on one CPU
worker (BASELINE.md).

Measurements (all in this one process; it never starts another):
- device-resident (the headline): the step-1 + step-2 programs on
  device-resident inputs, B=128 x 20 kbp, CCCTAAA k=5, timed with
  block_until_ready after warm-up (median of the timed calls).
- with transfers: the production launch path (host 2-bit pack ->
  transfer -> both stages -> per-batch result sync) with 4 batches in
  flight, as the engine runs it.
- e2e engine: one engine, two runs over a synthetic gzipped FASTQ; run
  1 absorbs compilation (e2e_cold_wall_s), run 2 reuses the same jitted
  programs and reports the steady-state rate.

The benchmark fails when JAX finds no GPU: a CPU number is never
reported under a device metric.
"""

import json
import os
import sys
import time

import numpy as np


def make_reads(rng, B, L, pattern="CCCTAAA"):
    """Telomere-like synthetic reads, already encoded (codes 0..3)."""
    base = rng.integers(0, 4, (B, L), dtype=np.uint8)
    pat = np.frombuffer(pattern.encode(), np.uint8)
    lut = np.full(256, 0, np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    pat_codes = lut[pat]
    telo_hi = min(5000, max(502, L // 2))
    telo_lens = rng.integers(500, telo_hi, B)
    reps = int(np.ceil(telo_lens.max() / len(pat_codes))) + 1
    tiled = np.tile(pat_codes, reps)
    for i in range(B):
        tl = int(telo_lens[i])
        seg = tiled[:tl].copy()
        noise = rng.random(tl) < 0.05
        seg[noise] = rng.integers(0, 4, int(noise.sum()), dtype=np.uint8)
        base[i, :tl] = seg
    return base


B = int(os.environ.get("TOPSICLE_BENCH_B", "128"))
READ_LEN = int(os.environ.get("TOPSICLE_BENCH_READ_LEN", "20000"))  # ~ONT long read
NO_BP = 1000
WINDOW, SLIDE, TRIM = 100, 6, 100
MLT = READ_LEN
K_PHRASE = 5


def _setup():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")

    from topsicle_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    from topsicle_tpu.io import batch as batching
    from topsicle_tpu.kmers import telophrase_kmers
    from topsicle_tpu.models import TelomereScanModel

    model = TelomereScanModel(
        telophrase_kmers("CCCTAAA", K_PHRASE), window_size=WINDOW, slide=SLIDE
    )
    rng = np.random.default_rng(42)
    reads = make_reads(rng, B, READ_LEN)
    ends = np.stack([np.concatenate([r[:NO_BP], r[-NO_BP:][::-1]]) for r in reads])
    ep = batching.pack_codes(ends.reshape(B * 2, NO_BP)).reshape(B, 2, -1)
    el = np.full(B, NO_BP, np.int32)
    tails = [batching.extract_tail(r, "forward", TRIM, MLT) for r in reads]
    tail_codes, lens = batching.tails_batch(tails, MLT - TRIM)
    nw = batching.window_counts_for_lengths(lens, WINDOW, SLIDE).astype(np.int32)
    return jax, batching, model, ends, ep, el, tail_codes, lens, nw


def _resident_measure(jax, batching, model, ep, el, tail_codes, lens, nw,
                      iters=50):
    """Both stages on device-resident inputs; median per-call time."""
    import jax.numpy as jnp

    args1 = (jnp.asarray(ep), jnp.asarray(el), model.table)
    args2 = (jnp.asarray(batching.pack_codes(tail_codes)),
             jnp.asarray(lens.astype(np.int32)), jnp.asarray(nw), model.table)

    def chain():
        return model._step1_lean(*args1), model._step2_lean(*args2)

    t0 = time.perf_counter()
    jax.block_until_ready(chain())
    startup_s = time.perf_counter() - t0
    for _ in range(3):
        jax.block_until_ready(chain())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(chain())
        times.append(time.perf_counter() - t0)
    best = float(np.median(times))
    bp_per_iter = B * (2 * NO_BP + tail_codes.shape[1])
    return {
        "ms_per_iter": best * 1e3,
        "mbps": bp_per_iter / best / 1e6,
        "reads_per_s": B / best,
        "startup_s": startup_s,
        "path": f"xla:{model.window_strategy}",
    }


def main():
    jax, batching, model, ends, ep, el, tail_codes, lens, nw = _setup()
    devs = jax.devices()
    device = {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
              "device_count": len(devs)}
    print(f"[bench] device: {device}", file=sys.stderr, flush=True)
    Lpad = tail_codes.shape[1]
    bp_per_iter = B * (2 * NO_BP + Lpad)

    resident = _resident_measure(jax, batching, model, ep, el, tail_codes,
                                 lens, nw)
    print(f"[bench] device-resident [{resident['path']}]: "
          f"{resident['ms_per_iter']} ms/iter = {resident['reads_per_s']} "
          f"reads/s, {resident['mbps']} Mbp/s (startup "
          f"{resident['startup_s']} s)", file=sys.stderr, flush=True)

    # ---- with transfers: the production launch path ----------------------
    def launch():
        c = model.step1_counts_launch(ends.reshape(B, 2, NO_BP), el)
        t, has = model.step2_boundary_launch(tail_codes, nw, lens)
        return c, t, has

    np.asarray(launch()[1])       # warm the launch-path programs
    iters = 16
    best_dt = None
    for _ in range(3):
        t0 = time.perf_counter()
        inflight = []
        for _ in range(iters):
            inflight.append(launch())
            if len(inflight) > 4:
                c, t, has = inflight.pop(0)
                np.asarray(c); np.asarray(t)
        for c, t, has in inflight:
            np.asarray(c); np.asarray(t)
        dt = time.perf_counter() - t0
        best_dt = dt if best_dt is None else min(best_dt, dt)
    xfer_mbps = bp_per_iter * iters / best_dt / 1e6
    print(f"[bench] with host pack+transfers: {B*iters/best_dt:.0f} reads/s, "
          f"{xfer_mbps:.1f} Mbp/s ({iters} iters pipelined depth 4, best "
          "of 3)", file=sys.stderr, flush=True)

    # ---- e2e engine secondary metric --------------------------------------
    e2e = {}
    if os.environ.get("TOPSICLE_BENCH_E2E", "1") not in ("0", "false"):
        import gzip as _gz
        import tempfile

        from benchmarks.e2e_cli import make_fastq
        from topsicle_tpu.config import TopsicleConfig
        from topsicle_tpu.io.writer import RunLog
        from topsicle_tpu.pipeline import JaxEngine

        n_reads = int(os.environ.get("TOPSICLE_BENCH_E2E_READS", "3200"))
        tmp = tempfile.mkdtemp()
        fq = os.path.join(tmp, "synthetic.fastq.gz")
        make_fastq(fq, n_reads)
        total_bp = 0
        with _gz.open(fq, "rt") as fh:
            for i, line in enumerate(fh):
                if i % 4 == 1:
                    total_bp += len(line) - 1
        # one engine, two runs: run 1 pays compilation; run 2 reuses the
        # SAME jitted programs and measures the steady-state engine
        cfg = TopsicleConfig(input_dir=fq, output_dir=os.path.join(tmp, "o1"),
                             pattern="CCCTAAA", slide=6)
        eng = JaxEngine(cfg, log=RunLog(None, echo=False))
        t0 = time.perf_counter()
        eng.run()
        cold = time.perf_counter() - t0
        cfg.output_dir = os.path.join(tmp, "o2")
        t0 = time.perf_counter()
        eng.run()
        warm = time.perf_counter() - t0
        import resource

        rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        e2e = {"e2e_reads_per_s": n_reads / warm,
               "e2e_mbps": total_bp / warm / 1e6,
               "e2e_wall_s": warm,
               "e2e_cold_wall_s": cold, "e2e_reads": n_reads,
               "e2e_peak_rss_mb": rss_mb}
        print(f"[bench] e2e engine: {n_reads} reads / {total_bp/1e6:.1f} Mbp; "
              f"cold {cold:.1f}s, warm {warm:.1f}s = "
              f"{e2e['e2e_reads_per_s']:.1f} reads/s "
              f"(incl. gzip parse, step1, subset, step2, CSV, aggregates)",
              file=sys.stderr, flush=True)

    out = {
        "metric": "device_scan_throughput",
        "value": resident["mbps"],
        "unit": "Mbp/s",
        "vs_baseline": resident["mbps"] / 0.4,
        **device,
        "sync": "block_until_ready",
        "resident_ms_per_iter": resident["ms_per_iter"],
        "startup_s": resident["startup_s"],
        "strategy": f"{model.window_strategy}/{model.greedy_strategy}",
        "batch_b": B,
        "transfer_mbps": xfer_mbps,
    }
    out.update(e2e)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""One-off profiling harness: decompose bench.py's per-iter time on the
GPU into dispatch latency, transfer, and per-stage device compute.
Diagnostics only — not part of the framework.
"""
import os, sys, time

import numpy as np
import jax
import jax.numpy as jnp

from topsicle_tpu.utils import enable_compilation_cache
enable_compilation_cache()

from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import telophrase_kmers
from topsicle_tpu.models import TelomereScanModel
from bench import make_reads


def timeit(label, fn, iters=10, warmup=2):
    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    print(f"[prof] {label}: {dt*1e3:.1f} ms", file=sys.stderr, flush=True)
    return dt


def main():
    rng = np.random.default_rng(42)
    B = 128
    read_len = 20000
    no_bp = 1000
    window_size, slide, trimfirst, mlt = 100, 6, 100, 20000

    model = TelomereScanModel(
        telophrase_kmers("CCCTAAA", 5), window_size=window_size, slide=slide
    )

    print(f"[prof] device: {jax.devices()[0]}", file=sys.stderr, flush=True)

    # 1. null dispatch round-trip
    tiny = jax.jit(lambda x: x + 1)
    xdev = jax.device_put(jnp.zeros((8,), jnp.int32))
    t0 = time.perf_counter(); jax.block_until_ready(tiny(xdev))
    print(f"[prof] tiny compile {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)
    timeit("null dispatch (jit+sync)", lambda: tiny(xdev), iters=20)

    # 2. transfer 1 MB host->device (sync via tiny op on it)
    buf = np.zeros((1 << 20,), np.uint8)
    timeit("device_put 1MB", lambda: jax.device_put(buf), iters=10)

    # build one variant
    reads = make_reads(rng, B, read_len)
    ends = np.stack([np.concatenate([r[:no_bp], r[-no_bp:][::-1]]) for r in reads])
    ep, em = batching.pack_batch(ends.reshape(B * 2, no_bp))
    tails = [batching.extract_tail(r, "forward", trimfirst, mlt) for r in reads]
    tail_codes, lens = batching.tails_batch(tails, max(len(t) for t in tails))
    tp, tm = batching.pack_batch(tail_codes)
    nw = batching.window_counts_for_lengths(lens, window_size, slide).astype(np.int32)
    ep = ep.reshape(B, 2, -1); em = em.reshape(B, 2, -1)

    # 3. host pack cost
    t0 = time.perf_counter()
    for _ in range(5):
        batching.pack_batch(tail_codes)
    print(f"[prof] host pack_batch tails: {(time.perf_counter()-t0)/5*1e3:.1f} ms",
          file=sys.stderr, flush=True)

    # 4. resident-input device compute (no transfer)
    dep, dem, dtp, dtm, dnw = map(jax.device_put, (ep, em, tp, tm, nw))
    t0 = time.perf_counter()
    jax.block_until_ready(model._step1(dep, dem, model.table))
    print(f"[prof] step1 compile {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)
    timeit("step1 device-only", lambda: model._step1(dep, dem, model.table))
    t0 = time.perf_counter()
    jax.block_until_ready(model._step2(dtp, dtm, dnw, model.table))
    print(f"[prof] step2 compile {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)
    timeit("step2 device-only", lambda: model._step2(dtp, dtm, dnw, model.table))

    # 5. transfer cost of the real batch (~1MB total, 5 arrays)
    timeit("device_put batch (5 arrays)",
           lambda: [jax.device_put(a) for a in (ep, em, tp, tm, nw)], iters=10)

    # 6. full launch, depth-4 pipeline (what bench.py measures)
    def launch():
        c = model._step1(jax.device_put(ep), jax.device_put(em), model.table)
        t, has = model._step2(jax.device_put(tp), jax.device_put(tm),
                              jax.device_put(nw), model.table)
        return c, t, has

    outs = []
    for _ in range(2):
        outs.append(launch())
    jax.block_until_ready(outs)
    iters = 10
    t0 = time.perf_counter()
    outs = []
    for _ in range(iters):
        outs.append(launch())
        if len(outs) > 4:
            jax.block_until_ready(outs.pop(0))
    jax.block_until_ready(outs)
    dt = (time.perf_counter() - t0) / iters
    print(f"[prof] full launch pipelined depth4: {dt*1e3:.1f} ms/iter", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()

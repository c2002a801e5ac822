"""Compile + time the phase window-scan strategy on the GPU."""
import os, sys, time
import numpy as np
import jax

from topsicle_tpu.utils import enable_compilation_cache
enable_compilation_cache()

from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import telophrase_kmers
from topsicle_tpu.models import TelomereScanModel
import importlib
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
bench = importlib.import_module("bench")

rng = np.random.default_rng(42)
B = 128
strategy = sys.argv[1] if len(sys.argv) > 1 else "phase"
model = TelomereScanModel(telophrase_kmers("CCCTAAA", 5), window_size=100,
                          slide=6, window_strategy=strategy)
reads = bench.make_reads(rng, B, 20000)
tails = [batching.extract_tail(r, "forward", 100, 20000) for r in reads]
tail_codes, lens = batching.tails_batch(tails, max(len(t) for t in tails))
tp = batching.pack_codes(tail_codes)
nw = batching.window_counts_for_lengths(lens, 100, 6).astype(np.int32)
dtp, dlens, dnw = map(jax.device_put, (tp, lens.astype(np.int32), nw))

t0 = time.perf_counter()
out = model._step2_lean(dtp, dlens, dnw, model.table)
jax.block_until_ready(out)
print(f"[{strategy}] compile+run {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)
for trial in range(3):
    t0 = time.perf_counter()
    outs = [model._step2_lean(dtp, dlens, dnw, model.table) for _ in range(20)]
    jax.block_until_ready(outs)
    print(f"[{strategy}] resident: {(time.perf_counter()-t0)/20*1e3:.2f} ms/iter",
          file=sys.stderr, flush=True)
print("t[:6] =", np.asarray(out[0])[:6], file=sys.stderr)

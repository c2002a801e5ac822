"""Decompose step-1 e2e time: parse vs pack vs launch vs sync."""
import os, sys, time, tempfile
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from topsicle_tpu.utils import enable_compilation_cache
enable_compilation_cache()
from benchmarks.e2e_cli import make_fastq


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    tmp = tempfile.mkdtemp()
    fq = os.path.join(tmp, "synthetic.fastq.gz")
    t0 = time.time(); make_fastq(fq, n); print(f"gen {time.time()-t0:.1f}s", file=sys.stderr)

    from topsicle_tpu.native import NativeReader, native_available
    print("native:", native_available(), file=sys.stderr)

    t0 = time.time()
    reads = list(NativeReader(fq, 9000))
    t_parse = time.time() - t0
    print(f"parse+encode {len(reads)} reads: {t_parse:.2f}s", file=sys.stderr)

    from topsicle_tpu.io import batch as batching
    from topsicle_tpu.kmers import telophrase_kmers
    from topsicle_tpu.models import TelomereScanModel
    import jax

    model = TelomereScanModel(telophrase_kmers("CCCTAAA", 5), window_size=100, slide=6)
    print("backend:", jax.default_backend(), file=sys.stderr)

    B = 128
    groups = [reads[i:i+B] for i in range(0, len(reads), B)]
    t0 = time.time()
    batches = []
    for g in groups:
        codes = [c for _, c in g]
        ends = batching.ends_batch(codes, 1000)
        ends_len = np.array([min(len(c), 1000) for c in codes], np.int32)
        if len(g) < B:
            ends = np.concatenate([ends, np.full((B-len(g), 2, 1000), 0xFF, np.uint8)])
            ends_len = np.concatenate([ends_len, np.zeros(B-len(g), np.int32)])
        batches.append((ends, ends_len))
    print(f"ends_batch x{len(groups)}: {time.time()-t0:.2f}s", file=sys.stderr)

    for it in range(3):
        t0 = time.time()
        futs = [model.step1_counts_launch(e, el) for e, el in batches]
        t_launch = time.time() - t0
        t0 = time.time()
        outs = [np.asarray(f) for f in futs]
        t_sync = time.time() - t0
        print(f"iter{it}: launch {t_launch:.2f}s sync {t_sync:.2f}s", file=sys.stderr)

    # step-2-shaped: pad tails
    tails = [batching.extract_tail(c, "forward", 100, 20000) for _, c in reads[:B]]
    t0 = time.time()
    tc, lens = batching.tails_batch(tails, max(len(t) for t in tails), 512)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    print(f"tails_batch: {time.time()-t0:.2f}s L={tc.shape[1]}", file=sys.stderr)
    for it in range(3):
        t0 = time.time()
        t_, has_ = model.step2_boundary(tc, nw, lens)
        print(f"step2 iter{it}: {time.time()-t0:.2f}s", file=sys.stderr)


if __name__ == "__main__":
    main()

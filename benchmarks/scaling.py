"""Read-parallel scaling harness: reads/s versus mesh size.

Weak scaling: every device gets the same per-device batch (so the total
batch grows with the mesh); perfect scaling = flat ms/iter, and
efficiency(n) = t(1) / t(n).  On a multi-GPU host this produces the
BASELINE scaling table (1 card -> N cards, >=90% target); on a CPU
host with virtual devices it validates the shard_map mechanism and
measures coordination overhead only (the absolute numbers are bounded
by the host's cores).

Usage:  [JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8]
        python benchmarks/scaling.py [per_device_batch] [read_len]
"""
import os
import sys, time
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax


    from topsicle_tpu.io import batch as batching
    from topsicle_tpu.kmers import telophrase_kmers
    from topsicle_tpu.models import TelomereScanModel
    from topsicle_tpu.parallel import ShardedScanModel, data_mesh

    per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    read_len = int(sys.argv[2]) if len(sys.argv) > 2 else 8192
    n_dev = len(jax.devices())
    print(f"[scaling] {n_dev} devices ({jax.devices()[0].platform}), "
          f"{per_dev} reads/device, {read_len} bp", file=sys.stderr, flush=True)

    base = TelomereScanModel(telophrase_kmers("CCCTAAA", 5), window_size=100, slide=6)
    rng = np.random.default_rng(0)

    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    t1 = None
    for n in sizes:
        model = ShardedScanModel(base, mesh=data_mesh(n)) if n > 1 else base
        B = per_dev * n
        ends = rng.integers(0, 4, (B, 2, 1000), dtype=np.uint8)
        ends_len = np.full(B, 1000, np.int32)
        tails = rng.integers(0, 4, (B, read_len), dtype=np.uint8)
        lens = np.full(B, read_len, np.int32)
        nw = batching.window_counts_for_lengths(lens, 100, 6)

        def launch():
            c = model.step1_counts_launch(ends, ends_len)
            t, h = model.step2_boundary_launch(tails, nw, lens)
            return c, t, h

        def sync(outs):
            jax.block_until_ready(outs)

        sync([launch()])                         # compile
        best = None
        for rep in range(3):
            t0 = time.perf_counter()
            outs = [launch() for _ in range(8)]
            sync(outs)
            dt = (time.perf_counter() - t0) / 8
            best = dt if best is None else min(best, dt)
        t1 = best if n == 1 else t1
        eff = t1 / best if t1 else float("nan")
        print(f"[scaling] mesh={n}: {best*1e3:7.1f} ms/iter, "
              f"{B/best:8.0f} reads/s, weak-scaling efficiency {eff:5.1%}",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()

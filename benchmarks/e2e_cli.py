"""End-to-end engine throughput on a synthetic ONT-like dataset.

Generates a gzipped FASTQ (default 2000 reads, ~15 kbp mean, ~30%
telomeric), runs the full JaxEngine pipeline (parse -> step1 -> subset
-> step2 -> CSV), and reports reads/s and Mbp/s including all host IO.
"""
import gzip, os, sys, tempfile, time
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from topsicle_tpu.utils import enable_compilation_cache
enable_compilation_cache()


def make_fastq(path, n_reads=2000, seed=7):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pat = "CCCTAAA"
    with gzip.open(path, "wt") as fh:
        for i in range(n_reads):
            L = int(rng.integers(9500, 22000))
            arr = bases[rng.integers(0, 4, L)]
            seq = arr.tobytes().decode()
            if rng.random() < 0.3:          # telomeric start
                tl = int(rng.integers(800, 4000))
                telo = (pat * (tl // len(pat) + 1))[:tl]
                telo = "".join(
                    c if rng.random() > 0.05 else "ACGT"[int(rng.integers(0, 4))]
                    for c in telo)
                seq = telo + seq[tl:]
            fh.write(f"@read_{i}\n{seq}\n+\n{'I'*len(seq)}\n")


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    tmp = tempfile.mkdtemp()
    fq = os.path.join(tmp, "synthetic.fastq.gz")
    t0 = time.time()
    make_fastq(fq, n_reads)
    print(f"[e2e] generated {n_reads} reads in {time.time()-t0:.1f}s "
          f"({os.path.getsize(fq)/1e6:.1f} MB gz)", file=sys.stderr, flush=True)

    from topsicle_tpu.config import TopsicleConfig
    from topsicle_tpu.io.writer import RunLog
    from topsicle_tpu.pipeline import JaxEngine

    out = os.path.join(tmp, "out")
    cfg = TopsicleConfig(input_dir=fq, output_dir=out, pattern="CCCTAAA", slide=6)
    t0 = time.time()
    results = JaxEngine(cfg, log=RunLog(out, echo=False)).run()
    dt = time.time() - t0
    import gzip as _gz
    total_bp = 0
    with _gz.open(fq, "rt") as fh:
        for i, line in enumerate(fh):
            if i % 4 == 1:
                total_bp += len(line) - 1
    import jax
    print(f"[e2e] device: {jax.devices()[0]}", file=sys.stderr)
    print(f"[e2e] {n_reads} reads / {total_bp/1e6:.1f} Mbp in {dt:.1f}s = "
          f"{n_reads/dt:.0f} reads/s, {total_bp/dt/1e6:.1f} Mbp/s; "
          f"{len(results)} passed step 1", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()

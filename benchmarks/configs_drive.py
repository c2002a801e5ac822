"""Drive BASELINE.json configs 3 and 4 end-to-end on the chip.

Config 3 — "Human ONT reads, pattern CCCTAA, multi-k telophrase sweep
{4,5,6}": k=5/6 rotations of CCCTAA contain bordered k-mers (e.g.
CTAAC), so their tables are PERIODIC and route to the exact
phase/chunked scan paths — the production fallback that the demo and
the bench headline (aperiodic k=5 CCCTAAA) never exercise — while k=4
stays aperiodic on the scan-free sum path; one run covers both device
path families, the per-phrase model cache, and multi-k aggregation
(reference multi-k loop: main.py:206).

Config 4 — "PacBio HiFi plant genome, maxlengthtelo=20000,
rawcountpattern per-window output": long accurate reads + the per-read
extras path (allsteps.py:359-464) through the round-4 shared-pack
pipeline.

Each config: synthesize a cohort, run the JaxEngine (on the GPU), run
the OracleEngine on the same input, assert byte-identical
telolengths_all.csv (and rawcount CSVs for config 4), and report
wall/stage rates.  `python chip_smoke.py` runs configs 2, 3 and 5 in
this way as the GPU bring-up check.

Usage: python benchmarks/configs_drive.py [config3|config4|all]
         [--reads N] [--out results.json]
"""

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from topsicle_tpu.config import TopsicleConfig  # noqa: E402
from topsicle_tpu.io.writer import RunLog  # noqa: E402


def _comp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))


def make_cohort(dirname, n_files, reads_per_file, pattern, *, mean_len,
                seed, gz=True):
    """Telomere-bearing synthetic long reads: ~60% forward-telomere,
    ~20% reverse-end telomere (reversed-complement repeat at the far
    end), ~20% non-telomeric; telomere tract 800-6000 bp with 4% noise;
    lengths ~N(mean_len, mean_len/4) clipped to >9100."""
    import gzip

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    os.makedirs(dirname, exist_ok=True)
    total_bp = 0
    for f in range(n_files):
        path = os.path.join(dirname, f"sample{f}.fastq" + (".gz" if gz else ""))
        op = gzip.open(path, "wt") if gz else open(path, "w")
        with op as fh:
            for i in range(reads_per_file):
                L = int(np.clip(rng.normal(mean_len, mean_len / 4), 9100, 60000))
                seq = rng.choice(bases, L)
                kind = rng.random()
                if kind < 0.8:
                    tl = int(rng.integers(800, 6000))
                    tract = (pattern * (tl // len(pattern) + 2))[:tl]
                    tract = np.array(list(tract))
                    noise = rng.random(tl) < 0.04
                    tract[noise] = rng.choice(bases, int(noise.sum()))
                    if kind < 0.6:
                        seq[:tl] = tract              # forward telomere
                    else:
                        # reverse tail: the complement strand's repeat
                        # sits reversed at the read's far end
                        rc = np.array(list(_comp("".join(tract))))[::-1]
                        seq[L - tl:] = rc
                s = "".join(seq)
                total_bp += L
                fh.write(f"@r{f}_{i}\n{s}\n+\n{'I' * L}\n")
    return total_bp


def make_cohort_fast(dirname, n_files, reads_per_file, pattern, *,
                     mean_len, seed, gz_level=2, telo_frac=0.8):
    """Byte-vectorized cohort generator for whole-genome-scale drives
    (config 2): same read mix as make_cohort but ~50x faster (uint8
    arrays end-to-end, no per-char Python), gzip level 2."""
    import gzip

    rng = np.random.default_rng(seed)
    B = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    pat = np.frombuffer(pattern.encode(), np.uint8)
    os.makedirs(dirname, exist_ok=True)
    total_bp = 0
    for f in range(n_files):
        path = os.path.join(dirname, f"sample{f}.fastq.gz")
        # mtime=0: the same seed gives the same bytes
        with gzip.GzipFile(path, "wb", compresslevel=gz_level,
                           mtime=0) as fh:
            for i in range(reads_per_file):
                L = int(np.clip(rng.normal(mean_len, mean_len / 4), 9100, 60000))
                seq = B[rng.integers(0, 4, L)]
                kind = rng.random()
                if kind < telo_frac:
                    tl = int(rng.integers(800, 6000))
                    tract = np.tile(pat, tl // len(pat) + 2)[:tl].copy()
                    noise = rng.random(tl) < 0.04
                    tract[noise] = B[rng.integers(0, 4, int(noise.sum()))]
                    if kind < telo_frac * 0.75:
                        seq[:tl] = tract
                    else:
                        seq[L - tl:] = comp[tract][::-1]
                total_bp += L
                fh.write(b"@r%d_%d\n" % (f, i))
                fh.write(seq.tobytes())
                fh.write(b"\n+\n")
                fh.write(b"I" * L)
                fh.write(b"\n")
    return total_bp


def _run_cli(argv, poll_outdir=None, kill_after_rows=None):
    """Run the topsicle CLI as a subprocess; returns (wall_s,
    peak_rss_mb, returncode, killed_at_rows).  With kill_after_rows,
    poll the output CSV and SIGKILL the exact child PID once it holds
    that many data rows (resume-interruption drives)."""
    import signal
    import subprocess

    csv_path = os.path.join(poll_outdir, "telolengths_all.csv") \
        if poll_outdir else None
    t0 = time.time()
    p = subprocess.Popen([sys.executable, "-m", "topsicle_tpu.cli"] + argv,
                         stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    killed_at = None
    done = None     # (status, rusage) once reaped
    if kill_after_rows is not None:
        # poll via non-blocking wait4 (NOT p.poll(), which reaps the
        # child and makes the final wait4 raise ECHILD if the run
        # finishes before the CSV reaches the kill threshold)
        while True:
            pid, status, ru = os.wait4(p.pid, os.WNOHANG)
            if pid:
                done = (status, ru)
                break
            time.sleep(1.0)
            try:
                with open(csv_path, "rb") as fh:
                    rows = fh.read().count(b"\n") - 1
            except OSError:
                rows = 0
            if rows >= kill_after_rows:
                killed_at = rows
                try:
                    os.kill(p.pid, signal.SIGKILL)  # exact PID, no patterns
                except ProcessLookupError:
                    killed_at = None   # finished between poll and kill
                break
    if done is None:
        _, status, ru = os.wait4(p.pid, 0)
    else:
        status, ru = done
    p.returncode = 0    # mark reaped so Popen's destructor stays quiet
    wall = time.time() - t0
    rc = os.waitstatus_to_exitcode(status) if hasattr(
        os, "waitstatus_to_exitcode") else status
    return wall, ru.ru_maxrss / 1024.0, rc, killed_at


def drive_config2(n_reads, record, telo_frac=0.8, key="config2"):
    """BASELINE config 2: 'A. thaliana whole-genome ONT run, single k
    (telophrase=5), windowSize=100 slide=7' at the reference's
    documented operating scale (README.md:266-270 prescribes >1 Gbp
    runs split into ~1 GB files) — >=50k reads / >=1 Gbp through the
    CLI on chip: sustained reads/s and Mbp/s, peak host RSS (the
    round-4 streamed pipeline's O(batch) claim), then a mid-run SIGKILL
    + --resume whose final CSV must be byte-identical to the
    uninterrupted run's."""
    tmp = tempfile.mkdtemp(prefix="cfg2_")
    indir = os.path.join(tmp, "in")
    n_files = 4
    t0 = time.time()
    total_bp = make_cohort_fast(indir, n_files, n_reads // n_files,
                                "CCCTAAA", mean_len=20000, seed=22,
                                telo_frac=telo_frac)
    gen_s = time.time() - t0
    gz_mb = sum(os.path.getsize(os.path.join(indir, f))
                for f in os.listdir(indir)) / 1e6
    base = ["--inputDir", indir, "--pattern", "CCCTAAA",
            "--telophrase", "5"]          # slide defaults to len(pattern)=7

    # uninterrupted run (the timing + RSS record)
    out_a = os.path.join(tmp, "a")
    wall, rss_mb, rc, _ = _run_cli(base + ["--outputDir", out_a])
    ok = rc == 0

    # kill mid-run once >=1 unit's rows hit the CSV, then --resume
    out_b = os.path.join(tmp, "b")
    kill_rows = 1
    w1, _, rc1, killed_at = _run_cli(base + ["--outputDir", out_b],
                                     poll_outdir=out_b,
                                     kill_after_rows=kill_rows)
    interrupted = killed_at is not None and rc1 != 0
    w2, _, rc2, _ = _run_cli(base + ["--outputDir", out_b, "--resume"])
    same = (open(os.path.join(out_a, "telolengths_all.csv"), "rb").read()
            == open(os.path.join(out_b, "telolengths_all.csv"), "rb").read())
    ok &= rc2 == 0 and same and interrupted

    rows = open(os.path.join(out_a, "telolengths_all.csv"),
                "rb").read().count(b"\n") - 1
    record[key] = {
        "pattern": "CCCTAAA", "telophrase": 5, "slide": 7,
        "telo_frac": telo_frac,
        "files": n_files, "reads": n_reads,
        "total_mbp": round(total_bp / 1e6, 1),
        "gz_mb": round(gz_mb, 1), "gen_s": round(gen_s, 1),
        "rows": rows,
        "cli_wall_s": round(wall, 1),
        "sustained_reads_per_s": round(n_reads / wall, 1),
        "sustained_mbps": round(total_bp / wall / 1e6, 2),
        "peak_rss_mb": round(rss_mb),
        "interrupted_run": {"killed_at_rows": killed_at,
                            "wall_to_kill_s": round(w1, 1),
                            "resume_wall_s": round(w2, 1)},
        "resume_csv_byte_identical": same,
        # the reference's guidance: >20 GB / >1M reads needs >=6 cores
        # and ~24 h (README.md:266-270) => ~12 reads/s sustained
        "vs_reference_guidance_x": round((n_reads / wall) / 12.0, 1),
    }
    return ok


def drive_config3_cutoff_grid(n_reads, record):
    """The cutoff-list clause of config 3:
    --cutoff 0.7 0.8 0.9 — min() filters step 1, cutoff[0] anchors the
    quadratic fit (reference main.py:56,254-257) — byte-checked against
    the host oracle on the chip."""
    tmp = tempfile.mkdtemp(prefix="cfg3grid_")
    indir = os.path.join(tmp, "in")
    total_bp = make_cohort(indir, 3, n_reads // 3, "CCCTAA",
                           mean_len=18000, seed=33)
    kw = dict(pattern="CCCTAA", telophrase=[4, 5, 6], slide=None,
              cutoff=[0.7, 0.8, 0.9])
    jt, jrows = run_engine("jax", indir, os.path.join(tmp, "j"), **kw)
    ot, orows = run_engine("oracle", indir, os.path.join(tmp, "o"), **kw)
    mismatch = diff_outputs(os.path.join(tmp, "j"), os.path.join(tmp, "o"))
    # the log's aggregate lines (inputtrc = cutoff[0] anchoring) must
    # also agree — they are where the cutoff-list semantics surface.
    # Only the AGGREGATE lines: the engines differ in per-file progress
    # chatter ("subsetting raw dataset..." is Jax-engine-only)
    def _agg(d):
        return [l.split("] ")[-1] for l in
                open(os.path.join(tmp, d, "topsicle_run.log")
                     ).read().splitlines()
                if "asymptotic TRC" in l or "Median telomere length" in l]

    la, lo = _agg("j"), _agg("o")
    record["config3_cutoff_grid"] = {
        "cutoff": [0.7, 0.8, 0.9], "reads": n_reads,
        "total_mbp": round(total_bp / 1e6, 1), "rows": jrows,
        "jax_wall_s": round(jt, 1), "oracle_wall_s": round(ot, 1),
        "csv_byte_identical": mismatch is None, "mismatch": mismatch,
        "aggregate_log_lines_identical": la == lo,
    }
    return mismatch is None and la == lo


def drive_config5_virtual(n_reads_per_file, record):
    """BASELINE config 5's mechanism at realistic scale, virtually
    10 genome files x ~1k reads across 2
    jax.distributed processes (4 virtual CPU devices each), BOTH
    --shardMode files and global; each merged CSV byte-identical to a
    single-process run; wall + reads/s recorded.  CPU-only — the real
    chip is single-device, and the mechanism (gloo-joined global mesh,
    GSPMD collectives, part-file merge) is what this exercises."""
    import socket
    import subprocess

    tmp = tempfile.mkdtemp(prefix="cfg5_")
    indir = os.path.join(tmp, "in")
    n_files = 10
    total_bp = make_cohort_fast(indir, n_files, n_reads_per_file,
                                "CCCTAAA", mean_len=12000, seed=55)
    n_reads = n_files * n_reads_per_file

    def single():
        out = os.path.join(tmp, "single")
        script = (
            "import os\n"
            "os.environ['XLA_FLAGS']='--xla_force_host_platform_device_count=4'\n"
            "import jax\njax.config.update('jax_platforms','cpu')\n"
            "import sys\nfrom topsicle_tpu.cli import main\n"
            f"sys.exit(main(['--inputDir',{indir!r},'--outputDir',{out!r},"
            "'--pattern','CCCTAAA','--slide','6']))\n")
        t0 = time.time()
        subprocess.run([sys.executable, "-c", script], check=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
        return time.time() - t0, out

    def dual(mode):
        out = os.path.join(tmp, mode)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        script = (
            "import os\n"
            "os.environ['XLA_FLAGS']='--xla_force_host_platform_device_count=4'\n"
            "import jax\njax.config.update('jax_platforms','cpu')\n"
            "import sys\nfrom topsicle_tpu.cli import main\n"
            "sys.exit(main(['--inputDir',{ind!r},'--outputDir',{outd!r},"
            "'--pattern','CCCTAAA','--slide','6','--shardMode',{mode!r},"
            "'--coordinator','127.0.0.1:{port}','--processId',{pid!r},"
            "'--processCount','2']))\n")
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-c", script.format(
                ind=indir, outd=out, mode=mode, port=port, pid=str(pid))],
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
            for pid in (0, 1)]
        errs = [p.communicate(timeout=1800)[1] for p in procs]
        for p, e in zip(procs, errs):
            if p.returncode != 0:
                raise RuntimeError(e.decode()[-2000:])
        return time.time() - t0, out

    st, sout = single()
    want = open(os.path.join(sout, "telolengths_all.csv"), "rb").read()
    entry = {"files": n_files, "reads": n_reads,
             "total_mbp": round(total_bp / 1e6, 1),
             "single_wall_s": round(st, 1),
             "single_reads_per_s": round(n_reads / st, 1)}
    ok = True
    for mode in ("files", "global"):
        mt, mout = dual(mode)
        same = open(os.path.join(mout, "telolengths_all.csv"),
                    "rb").read() == want
        entry[mode] = {"wall_s": round(mt, 1),
                       "reads_per_s": round(n_reads / mt, 1),
                       "csv_byte_identical_to_single": same}
        ok &= same
    record["config5_virtual"] = entry
    return ok


def _read_log_stages(outdir):
    txt = open(os.path.join(outdir, "topsicle_run.log")).read()
    m = re.findall(r"stages: (.*)", txt)
    return m


def run_engine(engine, indir, outdir, **cfg_kw):
    cfg = TopsicleConfig(input_dir=indir, output_dir=outdir, engine=engine,
                         **cfg_kw)
    log = RunLog(outdir, echo=False)
    t0 = time.time()
    from topsicle_tpu.pipeline import make_engine

    results = make_engine(cfg, log=log).run()
    return time.time() - t0, len(results)


def diff_outputs(a_dir, b_dir, patterns=("telolengths_all.csv",)):
    for pat in patterns:
        fa = sorted(glob.glob(os.path.join(a_dir, pat)))
        fb = sorted(glob.glob(os.path.join(b_dir, pat)))
        if [os.path.basename(x) for x in fa] != [os.path.basename(x) for x in fb]:
            return f"file sets differ for {pat}: {len(fa)} vs {len(fb)}"
        for x, y in zip(fa, fb):
            if open(x, "rb").read() != open(y, "rb").read():
                return f"bytes differ: {os.path.basename(x)}"
    return None


def drive_config3(n_reads, record):
    tmp = tempfile.mkdtemp(prefix="cfg3_")
    indir = os.path.join(tmp, "in")
    total_bp = make_cohort(indir, 3, n_reads // 3, "CCCTAA",
                           mean_len=18000, seed=33)
    kw = dict(pattern="CCCTAA", telophrase=[4, 5, 6], slide=None)
    jt, jrows = run_engine("jax", indir, os.path.join(tmp, "j"), **kw)
    ot, orows = run_engine("oracle", indir, os.path.join(tmp, "o"), **kw)
    mismatch = diff_outputs(os.path.join(tmp, "j"), os.path.join(tmp, "o"))
    from topsicle_tpu.kmers import all_aperiodic, telophrase_kmers

    record["config3"] = {
        "pattern": "CCCTAA", "telophrase": [4, 5, 6],
        "reads": n_reads, "total_mbp": round(total_bp / 1e6, 1),
        "rows": jrows,
        "paths": {k: ("sum(aperiodic)" if all_aperiodic(
            telophrase_kmers("CCCTAA", k)) else "phase/chunked(periodic)")
            for k in (4, 5, 6)},
        "jax_wall_s": round(jt, 1), "oracle_wall_s": round(ot, 1),
        "jax_reads_per_s": round(3 * n_reads / jt, 1),  # 3 k-passes
        "speedup_vs_oracle": round(ot / jt, 1),
        "csv_byte_identical": mismatch is None,
        "mismatch": mismatch,
        "stages": _read_log_stages(os.path.join(tmp, "j")),
    }
    return mismatch is None


def drive_config4(n_reads, record):
    tmp = tempfile.mkdtemp(prefix="cfg4_")
    indir = os.path.join(tmp, "in")
    # PacBio HiFi: long accurate reads, plant telomere CCCTAAA
    total_bp = make_cohort(indir, 1, n_reads, "CCCTAAA",
                           mean_len=16000, seed=44)
    kw = dict(pattern="CCCTAAA", slide=6, maxlengthtelo=20000)
    # plain run first (stage-time denominator for the extras overhead)
    pt, _ = run_engine("jax", indir, os.path.join(tmp, "p"), **kw)
    jt, jrows = run_engine("jax", indir, os.path.join(tmp, "j"),
                           rawcountpattern=True, **kw)
    ot, orows = run_engine("oracle", indir, os.path.join(tmp, "o"),
                           rawcountpattern=True, **kw)
    mismatch = diff_outputs(
        os.path.join(tmp, "j"), os.path.join(tmp, "o"),
        patterns=("telolengths_all.csv", "rawcount_*.csv"))
    n_raw = len(glob.glob(os.path.join(tmp, "j", "rawcount_*.csv")))
    record["config4"] = {
        "pattern": "CCCTAAA", "maxlengthtelo": 20000,
        "rawcountpattern": True, "reads": n_reads,
        "total_mbp": round(total_bp / 1e6, 1), "rows": jrows,
        "rawcount_csvs": n_raw,
        "jax_wall_s": round(jt, 1),
        "jax_wall_plain_s": round(pt, 1),
        "extras_overhead_x": round(jt / pt, 2),
        "oracle_wall_s": round(ot, 1),
        "speedup_vs_oracle": round(ot / jt, 1),
        "outputs_byte_identical": mismatch is None,
        "mismatch": mismatch,
        "stages_rawcount": _read_log_stages(os.path.join(tmp, "j")),
        "stages_plain": _read_log_stages(os.path.join(tmp, "p")),
    }
    return mismatch is None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="all",
                    choices=["config2", "config2real", "config3", "config3grid", "config4",
                             "config5", "all"])
    ap.add_argument("--reads", type=int, default=240)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from topsicle_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    record = {}
    ok = True
    if args.which == "config2":
        n = args.reads if args.reads != 240 else 52000
        ok &= drive_config2(n, record)
        print(json.dumps({"config2": record["config2"]}), flush=True)
    if args.which == "config2real":
        # realistic whole-genome mix: ~5% of reads carry a telomere
        # (a genome has 2 telomeres per chromosome vs thousands of
        # reads) — the sustained-rate record the reference's >20 GB /
        # 24 h guidance actually describes
        n = args.reads if args.reads != 240 else 52000
        ok &= drive_config2(n, record, telo_frac=0.05,
                            key="config2_realistic_mix")
        print(json.dumps(
            {"config2_realistic_mix": record["config2_realistic_mix"]}),
            flush=True)
    if args.which in ("config3", "all"):
        ok &= drive_config3(args.reads, record)
        print(json.dumps({"config3": record["config3"]}), flush=True)
    if args.which == "config3grid":
        ok &= drive_config3_cutoff_grid(args.reads, record)
        print(json.dumps(
            {"config3_cutoff_grid": record["config3_cutoff_grid"]}), flush=True)
    if args.which == "config5":
        n = args.reads if args.reads != 240 else 1000
        ok &= drive_config5_virtual(n, record)
        print(json.dumps({"config5_virtual": record["config5_virtual"]}),
              flush=True)
    if args.which in ("config4", "all"):
        ok &= drive_config4(args.reads, record)
        print(json.dumps({"config4": record["config4"]}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()

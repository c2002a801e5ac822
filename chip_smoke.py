#!/usr/bin/env python3
"""Run the telomere engine end to end on a GPU and check it exactly
against the host oracle.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the multi-card paths only

One card (phases, in order):
  1. (a) cold  - the `topsicle` CLI in a child process, empty compile
                 cache: whole-genome ONT, 4 gzipped files x 13,000 reads
                 (~1.04 Gbp, 5% telomeric), CCCTAAA, k=5, slide 7.
  2. (a) warm  - the same CLI in a second child, after the first exited.
  3. oracle    - (b) human mixed tables (CCCTAA, k 4 5 6, cutoffs
                 0.7 0.8 0.9, 2,000 reads, 80% telomeric) through the
                 CLI; both (a) and (b) re-run with `--engine oracle` and
                 compared byte for byte: telolengths_all.csv, every subset
                 FASTQ, and the aggregate log lines.
  4. kernel    - in this process: the XLA step-1 + step-2 chain at
                 B=128 x 19,968 bp, timed after warm-up, as device ms per
                 batch and as a share of the warm (a) wall per 128 reads.

--four-cards: BASELINE config 5's cohort cut to 10 files x 2,600 reads of
the (a) mix, run (i) by one process over four cards, (ii) with
--shardMode global as four processes of one card each, and compared byte
for byte with (iii) a one-card run.

The parent starts no JAX backend while a child holds a card.  Data is
generated from --seed into .chip_smoke/ and removed at the end.  The last
line of standard output is the JSON result; any failure exits non-zero
without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from benchmarks.configs_drive import make_cohort_fast  # noqa: E402
from topsicle_tpu.utils import compile_cache  # noqa: E402

WORK = os.path.join(REPO, ".chip_smoke")
SHARE_RULE = 0.05     # below this device share, no kernel can move e2e


class SmokeFailure(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Cohort:
    name: str
    pattern: str
    files: int
    reads_per_file: int
    mean_len: int
    telo_frac: float
    cli: tuple           # analysis flags beyond --pattern

    @property
    def reads(self) -> int:
        return self.files * self.reads_per_file


# BASELINE.json config 2 (whole-genome ONT, realistic 5% telomeric mix)
COHORT_A = Cohort("a", "CCCTAAA", 4, 13_000, 20_000, 0.05,
                  ("--telophrase", "5", "--slide", "7", "--windowSize", "100"))
# BASELINE.json config 3 (human CCCTAA: sum, split+bitmask, split+offset)
COHORT_B = Cohort("b", "CCCTAA", 1, 2_000, 18_000, 0.8,
                  ("--telophrase", "4", "5", "6",
                   "--cutoff", "0.7", "0.8", "0.9"))
# BASELINE.json config 5 (multi-genome cohort), cut to 10 x 2,600 reads
COHORT_FOUR = Cohort("four", "CCCTAAA", 10, 2_600, 20_000, 0.05,
                     COHORT_A.cli)

# message prefixes of aggregate.summarize_phrase's log lines
AGG_PREFIXES = (
    "k-mer: ", "Not enough data points", "Asymptotic TRC", "Using median TRC",
    "Using 0.9 as", "Quadratic fit suggests", "Maximum TRC value",
    "asymptotic TRC, or recommended", "Median telomere length for reads",
    "No read has TRC",
)

PROBE = ("import jax, json; d = jax.devices(); print(json.dumps({"
         "'platform': d[0].platform, 'kind': d[0].device_kind, "
         "'count': len(d), 'jax': jax.__version__}))")


def say(*args) -> None:
    print(*args, flush=True)


# ---- pieces (each callable without a card) --------------------------------

def phases(four_cards: bool) -> list:
    """The phases a run executes, in order."""
    if four_cards:
        return ["four_cards"]
    return ["a_cold", "a_warm", "oracle", "kernel"]


def check_device(info: dict, count: int | None = None) -> None:
    """Refuse anything but JAX on GPUs (and the expected card count)."""
    if info.get("platform") != "gpu":
        raise SmokeFailure(f"JAX found no GPU: platform {info.get('platform')!r}")
    if count is not None and info.get("count") != count:
        raise SmokeFailure(f"expected {count} GPUs, JAX sees {info.get('count')}")


def contract_line(info: dict) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def generate(cohort: Cohort, dirname: str, seed: int) -> int:
    """Write the cohort's gzipped FASTQ files; returns total bp."""
    return make_cohort_fast(dirname, cohort.files, cohort.reads_per_file,
                            cohort.pattern, mean_len=cohort.mean_len,
                            seed=seed, telo_frac=cohort.telo_frac)


def aggregate_lines(outdir: str) -> list:
    """The aggregate messages of a run log, timestamps stripped."""
    out = []
    with open(os.path.join(outdir, "topsicle_run.log")) as fh:
        for line in fh:
            msg = line.rstrip("\n").split("] ", 1)[-1]
            if msg.startswith(AGG_PREFIXES):
                out.append(msg)
    return out


def compare_outputs(got: str, want: str, n_phrases: int) -> list:
    """Byte-level differences between two output directories: the CSV,
    every subset FASTQ, and the aggregate log lines.  Empty = identical."""
    diffs = []

    def read(path):
        with open(path, "rb") as fh:
            return fh.read()

    if read(os.path.join(got, "telolengths_all.csv")) != \
            read(os.path.join(want, "telolengths_all.csv")):
        diffs.append("telolengths_all.csv")
    subsets = {}
    for d in (got, want):
        subsets[d] = sorted(os.path.basename(p) for p in
                            glob.glob(os.path.join(d, "*_trc_over_*"))
                            if not p.endswith(".tmp"))
    if subsets[got] != subsets[want] or not subsets[want]:
        diffs.append(f"subset file sets {subsets[got]} vs {subsets[want]}")
    else:
        for name in subsets[want]:
            if read(os.path.join(got, name)) != read(os.path.join(want, name)):
                diffs.append(name)
    agg_got, agg_want = aggregate_lines(got), aggregate_lines(want)
    if agg_got != agg_want:
        diffs.append("aggregate log lines")
    if sum(m.startswith("k-mer: ") for m in agg_want) != n_phrases:
        diffs.append(f"expected {n_phrases} per-k aggregate blocks")
    return diffs


def csv_rows(outdir: str) -> int:
    with open(os.path.join(outdir, "telolengths_all.csv"), "rb") as fh:
        return fh.read().count(b"\n") - 1


def log_value(outdir: str, prefix: str) -> str:
    """The first run-log message starting with `prefix` ('' if none)."""
    with open(os.path.join(outdir, "topsicle_run.log")) as fh:
        for line in fh:
            msg = line.rstrip("\n").split("] ", 1)[-1]
            if msg.startswith(prefix):
                return msg
    return ""


def cache_entries(path: str | None) -> int:
    if not path or not os.path.isdir(path):
        return 0
    return sum(len(files) for _, _, files in os.walk(path))


# ---- child processes ------------------------------------------------------

class Children:
    """Every process this script starts; all are stopped on exit."""

    def __init__(self):
        self.procs = []

    def start(self, argv, log_path, env_extra=None):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        env.update(env_extra or {})
        with open(log_path, "w") as log:
            p = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                                 env=env, cwd=REPO)
        p.log_path = log_path
        self.procs.append(p)
        return p

    def wait(self, p, timeout: float, what: str) -> None:
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            raise SmokeFailure(f"{what}: no result within {timeout:.0f} s")
        if rc != 0:
            with open(p.log_path, errors="replace") as fh:
                tail = fh.read()[-3000:]
            raise SmokeFailure(f"{what}: exit code {rc}\n{tail}")

    def stop_all(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def cli_argv(cohort: Cohort, indir: str, outdir: str, *extra) -> list:
    return [sys.executable, "-m", "topsicle_tpu.cli", "--inputDir", indir,
            "--outputDir", outdir, "--pattern", cohort.pattern,
            *cohort.cli, *extra]


def run_cli(kids: Children, what: str, argv: list, outdir: str,
            timeout: float, env_extra=None) -> float:
    os.makedirs(outdir, exist_ok=True)
    t0 = time.perf_counter()
    p = kids.start(argv, os.path.join(outdir, "child.out"), env_extra)
    kids.wait(p, timeout, what)
    return time.perf_counter() - t0


def probe_devices(kids: Children, env_extra=None) -> dict:
    os.makedirs(WORK, exist_ok=True)
    p = kids.start([sys.executable, "-c", PROBE],
                   os.path.join(WORK, "probe.out"), env_extra)
    kids.wait(p, 300, "device probe")
    with open(p.log_path) as fh:
        return json.loads(fh.read().strip().splitlines()[-1])


def nvidia_smi() -> list:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        raise SmokeFailure(f"nvidia-smi unavailable: {e}")
    if r.returncode != 0 or not r.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()


def report_run(tag: str, wall: float, cohort: Cohort, bp: int,
               outdir: str) -> None:
    say(f"[{tag}] wall {wall:.3f} s, {cohort.reads / wall:.1f} reads/s, "
        f"{bp / wall / 1e6:.2f} Mbp/s, {csv_rows(outdir)} rows; "
        f"{log_value(outdir, 'reader:')}")


def check_identical(tag: str, got: str, want: str, n_phrases: int) -> None:
    diffs = compare_outputs(got, want, n_phrases)
    if diffs:
        raise SmokeFailure(f"{tag}: outputs differ: {diffs}")
    say(f"[{tag}] telolengths_all.csv, subset FASTQ and aggregate lines "
        "byte-identical")


# ---- the one-card run -----------------------------------------------------

def run_single_card(kids: Children, work: str, seed: int,
                    a: Cohort = COHORT_A, b: Cohort = COHORT_B) -> dict:
    """Phases 1-3; returns what phase 4 needs."""
    data = {}
    for i, c in enumerate((a, b)):
        t0 = time.perf_counter()
        bp = generate(c, os.path.join(work, f"in_{c.name}"), seed * 10 + i)
        data[c.name] = bp
        say(f"[data {c.name}] {c.files} files x {c.reads_per_file} reads = "
            f"{bp / 1e9:.3f} Gbp in {time.perf_counter() - t0:.1f} s")
    ind_a, ind_b = (os.path.join(work, f"in_{c.name}") for c in (a, b))

    cdir = compile_cache.cache_dir()
    if cdir == compile_cache.DEFAULT_CACHE_DIR:
        shutil.rmtree(cdir, ignore_errors=True)   # our own cache: start cold
    say(f"[cache] {cdir}: {cache_entries(cdir)} entries before (a) cold")

    out = {c: os.path.join(work, f"out_{c}") for c in
           ("a_cold", "a_warm", "a_oracle", "b", "b_oracle")}
    cold = run_cli(kids, "(a) cold", cli_argv(a, ind_a, out["a_cold"]),
                   out["a_cold"], 600)
    report_run("a cold", cold, a, data["a"], out["a_cold"])
    say(f"[cache] {cache_entries(cdir)} entries after (a) cold")
    warm = run_cli(kids, "(a) warm", cli_argv(a, ind_a, out["a_warm"]),
                   out["a_warm"], 600)
    report_run("a warm", warm, a, data["a"], out["a_warm"])
    say(f"[cache] {cache_entries(cdir)} entries after (a) warm")

    # the oracles run on host cores only; (b) holds the card meanwhile
    t0 = time.perf_counter()
    oracles = []
    for c, ind, o in ((a, ind_a, out["a_oracle"]), (b, ind_b, out["b_oracle"])):
        os.makedirs(o, exist_ok=True)
        oracles.append((c, o, kids.start(
            cli_argv(c, ind, o, "--engine", "oracle"),
            os.path.join(o, "child.out"))))
    wall_b = run_cli(kids, "(b)", cli_argv(b, ind_b, out["b"]), out["b"], 600)
    report_run("b", wall_b, b, data["b"], out["b"])
    for c, o, p in oracles:
        kids.wait(p, 900, f"({c.name}) oracle")
    say(f"[oracle] both oracle runs done {time.perf_counter() - t0:.1f} s "
        "after they started")
    check_identical("a cold vs warm", out["a_cold"], out["a_warm"], 1)
    check_identical("a vs oracle", out["a_warm"], out["a_oracle"], 1)
    check_identical("b vs oracle", out["b"], out["b_oracle"], 3)
    return {"warm_wall_s": warm, "reads": a.reads}


def kernel_decision(seed: int, warm_wall_s: float, reads: int,
                    iters: int = 30) -> dict:
    """Phase 4: the XLA step-1 + step-2 chain of (a)'s table at the
    engine's batch and static tail length, in this process."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from topsicle_tpu.config import TopsicleConfig
    from topsicle_tpu.io import batch as batching
    from topsicle_tpu.kmers import patterns_to_search
    from topsicle_tpu.models import TelomereScanModel

    cfg = TopsicleConfig(input_dir="-", output_dir="-", pattern="CCCTAAA",
                         telophrase=[5], slide=7)
    B, L, no_bp = cfg.batch_size, cfg.static_scan_length(), cfg.no_bp
    model = TelomereScanModel(patterns_to_search(cfg.pattern, 5),
                              window_size=cfg.window_size,
                              slide=cfg.slide_value())
    rng = np.random.default_rng(seed)
    ends = rng.integers(0, 4, (B * 2, no_bp), dtype=np.uint8)
    tails = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lens = rng.integers(9_000, L + 1, B).astype(np.int32)
    tails[np.arange(L)[None, :] >= lens[:, None]] = 0xFF
    nw = batching.window_counts_for_lengths(lens, cfg.window_size,
                                            cfg.slide_value())
    args1 = (jnp.asarray(batching.pack_codes(ends).reshape(B, 2, -1)),
             jnp.full((B,), no_bp, jnp.int32), model.table)
    args2 = (jnp.asarray(batching.pack_codes(tails)), jnp.asarray(lens),
             jnp.asarray(nw), model.table)
    for name, prog, a in (("step1", model._step1_lean, args1),
                          ("step2", model._step2_lean, args2)):
        say(f"[kernel] {name} memory_analysis: "
            f"{prog.lower(*a).compile().memory_analysis()}")

    def chain():
        return model._step1_lean(*args1), model._step2_lean(*args2)

    for _ in range(3):
        jax.block_until_ready(chain())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(chain())
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    per_batch_ms = warm_wall_s * 1e3 / (reads / B)
    share = ms / per_batch_ms
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    say(f"[kernel] XLA step1+step2 chain, B={B} x {L} bp: median {ms:.4f} ms "
        f"per batch over {iters} runs (min {min(times) * 1e3:.4f}, max "
        f"{max(times) * 1e3:.4f}); warm (a) wall per {B} reads "
        f"{per_batch_ms:.4f} ms; device share {share * 100:.3f}%")
    verdict = ("below" if share < SHARE_RULE else "at or above")
    say(f"[kernel] share is {verdict} {SHARE_RULE:.0%}: "
        + ("no step-2 kernel can move the e2e metric; the XLA chain stays"
           if share < SHARE_RULE else "a Hopper step-2 kernel may pay"))
    say(f"[kernel] peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


# ---- the four-card run ----------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_four_cards(kids: Children, work: str, seed: int,
                   cohort: Cohort = COHORT_FOUR, n: int = 4,
                   per_card_env=None) -> None:
    """(i) one process over n cards and (ii) --shardMode global as n
    one-card processes, each byte-compared with (iii) a one-card run.
    `per_card_env(i)` gives the environment that pins process i to one
    card (CUDA_VISIBLE_DEVICES by default)."""
    per_card_env = per_card_env or (lambda i: {"CUDA_VISIBLE_DEVICES": str(i)})
    ind = os.path.join(work, "in_four")
    t0 = time.perf_counter()
    bp = generate(cohort, ind, seed * 10 + 5)
    say(f"[data four] {cohort.files} files x {cohort.reads_per_file} reads = "
        f"{bp / 1e9:.3f} Gbp in {time.perf_counter() - t0:.1f} s")
    out1, out4, outg = (os.path.join(work, f"out_{t}")
                        for t in ("one_card", "one_process", "global"))
    wall = run_cli(kids, "(iii) one card", cli_argv(cohort, ind, out1), out1,
                   600, per_card_env(0))
    report_run("one card", wall, cohort, bp, out1)
    wall = run_cli(kids, f"(i) one process, {n} cards",
                   cli_argv(cohort, ind, out4), out4, 600)
    report_run(f"one process, {n} cards", wall, cohort, bp, out4)

    os.makedirs(outg, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [kids.start(
        cli_argv(cohort, ind, outg, "--shardMode", "global",
                 "--coordinator", f"localhost:{port}",
                 "--processId", str(i), "--processCount", str(n)),
        os.path.join(outg, f"child{i}.out"), per_card_env(i))
        for i in range(n)]
    for i, p in enumerate(procs):
        kids.wait(p, 600, f"(ii) global process {i}")
    report_run(f"global, {n} processes", time.perf_counter() - t0, cohort,
               bp, outg)
    check_identical(f"one process over {n} cards vs one card", out4, out1, 1)
    check_identical(f"global over {n} processes vs one card", outg, out1, 1)


# ---- entry point ----------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated reads")
    args = ap.parse_args(argv)
    kids = Children()
    t_start = time.perf_counter()
    try:
        cards = nvidia_smi()
        for line in cards:
            say(f"nvidia-smi: {line}")
        info = probe_devices(kids)
        check_device(info, 4 if args.four_cards else None)
        say(f"jax {info['jax']}, device_kind {info['kind']}, "
            f"{info['count']} device(s); phases {phases(args.four_cards)}")
        from topsicle_tpu.native import native_available, unavailable_reason
        from topsicle_tpu.native.loader import library_path

        say("reader: " + ("native C++ " + os.path.relpath(library_path(), REPO)
                          if native_available() else
                          f"Python ({unavailable_reason()})"))
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        if args.four_cards:
            run_four_cards(kids, WORK, args.seed)
        else:
            res = run_single_card(kids, WORK, args.seed)
            final = kernel_decision(args.seed, res["warm_wall_s"],
                                    res["reads"])
            check_device(final)
        say(f"total {time.perf_counter() - t_start:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        kids.stop_all()
        shutil.rmtree(WORK, ignore_errors=True)
    for line in cards:
        say(f"card: {line}")
    print(contract_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

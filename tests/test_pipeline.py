"""End-to-end JAX engine vs golden demo outputs and vs the oracle."""

import gzip
import os
import random

import numpy as np
import pytest

from tests.conftest import requires_demo

from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.pipeline import JaxEngine, make_engine
from topsicle_tpu.oracle import OracleEngine


def _demo_cfg(demo_fastq, outdir, **kw):
    return TopsicleConfig(
        input_dir=demo_fastq, output_dir=str(outdir), pattern="CCCTAAA",
        slide=6, batch_size=8, **kw,
    )


@requires_demo
def test_jax_engine_demo_bitexact(demo_fastq, demo_csv, tmp_path):
    results = JaxEngine(_demo_cfg(demo_fastq, tmp_path)).run()
    assert len(results) == 17
    with open(demo_csv, "rb") as fh:
        want = fh.read()
    with open(tmp_path / "telolengths_all.csv", "rb") as fh:
        got = fh.read()
    assert got == want


@requires_demo
def test_jax_engine_demo_subset(demo_fastq, demo_subset, tmp_path):
    JaxEngine(_demo_cfg(demo_fastq, tmp_path)).run()
    name = "Col-0-6909_GWHBDNP00000001.1_nano_right.fastq_trc_over_0.7.fastq"
    with open(demo_subset) as fh:
        assert (tmp_path / name).read_text() == fh.read()


def _write_synthetic_fastq(path, rng, n_reads=40, pattern="CCCTAAA"):
    with gzip.open(path, "wt") as fh:
        for i in range(n_reads):
            kind = i % 4
            total = rng.randrange(9500, 22000)
            if kind == 0:  # forward telomere
                telo_len = rng.randrange(200, 5000)
                telo = (pattern * (telo_len // len(pattern) + 1))[:telo_len]
                telo = "".join(c if rng.random() > 0.07 else rng.choice("ACGT") for c in telo)
                seq = telo + "".join(rng.choice("ACGT") for _ in range(total - telo_len))
            elif kind == 1:  # reverse telomere
                telo_len = rng.randrange(200, 5000)
                telo = (pattern * (telo_len // len(pattern) + 1))[:telo_len]
                seq = ("".join(rng.choice("ACGT") for _ in range(total - telo_len)) + telo)[::-1][::-1]
                seq = seq[::-1]  # telomere at the end, reversed orientation
            elif kind == 2:  # junk
                seq = "".join(rng.choice("ACGT") for _ in range(total))
            else:  # short read (filtered) or N-rich
                if i % 8 == 3:
                    seq = "".join(rng.choice("ACGT") for _ in range(rng.randrange(100, 8000)))
                else:
                    seq = "".join(
                        rng.choice("ACGTN") if rng.random() < 0.1 else rng.choice("ACGT")
                        for _ in range(total)
                    )
            fh.write(f"@read{i} synthetic\n{seq}\n+\n{'I' * len(seq)}\n")


def test_jax_engine_matches_oracle_synthetic(tmp_path):
    rng = random.Random(99)
    data = tmp_path / "synthetic.fastq.gz"
    _write_synthetic_fastq(str(data), rng)

    cfg_o = TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "o"),
                           pattern="CCCTAAA", slide=6)
    cfg_j = TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "j"),
                           pattern="CCCTAAA", slide=6, batch_size=8)
    OracleEngine(cfg_o).run()
    JaxEngine(cfg_j).run()
    want = (tmp_path / "o" / "telolengths_all.csv").read_bytes()
    got = (tmp_path / "j" / "telolengths_all.csv").read_bytes()
    assert got == want


def test_jax_engine_k_exceeds_pattern_length(tmp_path):
    """k > len(pattern) is legal: the reference cuts k-mers from the
    DOUBLED pattern (allsteps.py:66-76), so 8-mers of a 7-bp repeat
    exist.  Engine and oracle must agree byte-for-byte."""
    rng = random.Random(21)
    data = tmp_path / "s.fastq.gz"
    _write_synthetic_fastq(str(data), rng, n_reads=16)
    kw = dict(input_dir=str(data), pattern="CCCTAAA", telophrase=[8], slide=6)
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), batch_size=8, **kw)).run()
    OracleEngine(TopsicleConfig(output_dir=str(tmp_path / "o"), **kw)).run()
    assert (tmp_path / "j" / "telolengths_all.csv").read_bytes() == \
           (tmp_path / "o" / "telolengths_all.csv").read_bytes()


def test_config_k_bounds():
    base = dict(input_dir="x", output_dir="y", pattern="CCCTAAA")
    TopsicleConfig(telophrase=[14], **base).validate()      # 2*len -> ok
    with pytest.raises(ValueError):                         # > 2*len
        TopsicleConfig(telophrase=[15], **base).validate()
    # k > 15 in files mode falls back to the host oracle path per
    # phrase (pipeline._model), so validate accepts it...
    TopsicleConfig(pattern="CCCTAAACCCTAAA", telophrase=[16],
                   input_dir="x", output_dir="y").validate()
    with pytest.raises(ValueError):  # ...but global lockstep mode cannot
        TopsicleConfig(pattern="CCCTAAACCCTAAA", telophrase=[16],
                       shard_mode="global",
                       input_dir="x", output_dir="y").validate()
    with pytest.raises(ValueError):                         # k >= windowSize
        TopsicleConfig(telophrase=[10], window_size=10, **base).validate()


def test_threads_byte_identity(tmp_path):
    """--threads N runs N concurrent file readers; the device still
    consumes files in order, so the CSV must be byte-identical at any
    thread count."""
    rng = random.Random(31)
    d = tmp_path / "in"
    d.mkdir()
    for f in range(5):
        _write_synthetic_fastq(str(d / f"f{f}.fastq.gz"), rng, n_reads=6)
    outs = []
    for th in (1, 2, 4):
        cfg = TopsicleConfig(input_dir=str(d), output_dir=str(tmp_path / f"t{th}"),
                             pattern="CCCTAAA", slide=6, batch_size=8, threads=th)
        JaxEngine(cfg).run()
        outs.append((tmp_path / f"t{th}" / "telolengths_all.csv").read_bytes())
    assert outs[0] == outs[1] == outs[2]
    assert outs[0].count(b"\n") > 1   # non-trivial output


def test_jax_engine_k16_oracle_fallback(tmp_path):
    """telophrase 16 > MAX_ROLLING_K: the JAX engine must swap in the
    host oracle model for that phrase (instead of erroring the run) and
    still match the oracle engine byte-for-byte."""
    rng = random.Random(5)
    data = tmp_path / "s.fastq.gz"
    _write_synthetic_fastq(str(data), rng, n_reads=8, pattern="CCCTAAACC")
    kw = dict(input_dir=str(data), pattern="CCCTAAACC", telophrase=[16])
    JaxEngine(TopsicleConfig(output_dir=str(tmp_path / "j"), batch_size=4, **kw)).run()
    OracleEngine(TopsicleConfig(output_dir=str(tmp_path / "o"), **kw)).run()
    assert (tmp_path / "j" / "telolengths_all.csv").read_bytes() == \
           (tmp_path / "o" / "telolengths_all.csv").read_bytes()


def test_jax_engine_multi_k(tmp_path):
    rng = random.Random(7)
    data = tmp_path / "s.fastq.gz"
    _write_synthetic_fastq(str(data), rng, n_reads=16)
    cfg = TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "j"),
                         pattern="CCCTAA", telophrase=[4, 5], batch_size=8)
    cfg_o = TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "o"),
                           pattern="CCCTAA", telophrase=[4, 5])
    JaxEngine(cfg).run()
    OracleEngine(cfg_o).run()
    assert (tmp_path / "j" / "telolengths_all.csv").read_bytes() == \
           (tmp_path / "o" / "telolengths_all.csv").read_bytes()


@requires_demo
def test_read_check_single_row(demo_fastq, tmp_path):
    rid = "ERR11436636.206253"
    JaxEngine(_demo_cfg(demo_fastq, tmp_path, read_check=rid)).run()
    lines = (tmp_path / "telolengths_all.csv").read_text().strip().splitlines()
    assert len(lines) == 2  # header + the one read
    assert rid in lines[1]
    assert lines[1].endswith("1870")  # golden value from demo CSV


@requires_demo
def test_read_check_missing_read_refused(demo_fastq, tmp_path):
    with pytest.raises(ValueError):
        JaxEngine(_demo_cfg(demo_fastq, tmp_path, read_check="nope.1")).run()


@requires_demo
def test_rawcountpattern_csv(demo_fastq, tmp_path):
    JaxEngine(_demo_cfg(demo_fastq, tmp_path, rawcountpattern=True,
                        read_check="ERR11436636.206253")).run()
    raw = (tmp_path / "rawcount_5_1.csv").read_text().splitlines()
    assert raw[0] == ",tail,position,pattern,count"
    # first window, first k-mer row
    first = raw[1].split(",")
    assert first[0] == "0" and first[2] == "0" and first[3] == "AAACC"
    assert int(first[4]) >= 1
    # schema matches the reference artifact (stale demo rawcount_4_1.csv
    # is schema-only — SURVEY.md §8 item 12)


def test_make_engine_dispatch(tmp_path):
    cfg = TopsicleConfig(input_dir="x", output_dir=str(tmp_path), pattern="CCCTAAA",
                         engine="oracle")
    assert isinstance(make_engine(cfg), OracleEngine)
    cfg2 = TopsicleConfig(input_dir="x", output_dir=str(tmp_path), pattern="CCCTAAA")
    assert isinstance(make_engine(cfg2), JaxEngine)


@requires_demo
def test_cli_end_to_end(demo_fastq, demo_csv, tmp_path, capsys):
    from topsicle_tpu.cli import main

    rc = main([
        "--inputDir", demo_fastq,
        "--outputDir", str(tmp_path),
        "--pattern", "CCCTAAA",
        "--slide", "6",
        "--batchSize", "8",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "All telomere found, have a nice day." in out
    assert "Elapsed time(s):" in out
    with open(demo_csv, "rb") as fh:
        assert (tmp_path / "telolengths_all.csv").read_bytes() == fh.read()
    # quadfit plot saved unconditionally when >= 3 points
    assert (tmp_path / "quadfit_5mer_CCCTAAA.png").exists()


@requires_demo
def test_cli_override_guard(demo_fastq, tmp_path):
    from topsicle_tpu.cli import main

    args = ["--inputDir", demo_fastq, "--outputDir", str(tmp_path),
            "--pattern", "CCCTAAA", "--slide", "6", "--batchSize", "8"]
    assert main(args) == 0
    assert main(args) == 1           # refuses without --override
    assert main(args + ["--override"]) == 0


@requires_demo
def test_global_mode_extras_match_files_mode(tmp_path, demo_fastq):
    """--rawcountpattern and --plot now work in shardMode=global and
    produce the same artifacts as files mode (same names, same bytes for
    the rawcount CSVs)."""
    import filecmp

    from topsicle_tpu.config import TopsicleConfig
    from topsicle_tpu.pipeline import JaxEngine

    outs = {}
    for mode in ("files", "global"):
        out = tmp_path / mode
        cfg = TopsicleConfig(
            input_dir=demo_fastq, output_dir=str(out), pattern="CCCTAAA",
            slide=6, batch_size=8, shard_mode=mode, rawcountpattern=True)
        JaxEngine(cfg).run()
        outs[mode] = out
    a = sorted(p.name for p in outs["files"].glob("rawcount_*.csv"))
    b = sorted(p.name for p in outs["global"].glob("rawcount_*.csv"))
    assert a and a == b
    for name in a:
        assert filecmp.cmp(outs["files"] / name, outs["global"] / name,
                           shallow=False), name
    assert (outs["files"] / "telolengths_all.csv").read_bytes() == \
        (outs["global"] / "telolengths_all.csv").read_bytes()


@requires_demo
def test_scan_length_modes_identical(demo_fastq, tmp_path):
    """scan_length_mode='static' (one device program, the default) and
    'bucket' (per-batch padded lengths) produce byte-identical CSVs."""
    outs = {}
    for mode in ("static", "bucket"):
        out = tmp_path / mode
        cfg = _demo_cfg(demo_fastq, out, scan_length_mode=mode)
        JaxEngine(cfg).run()
        outs[mode] = (out / "telolengths_all.csv").read_bytes()
    assert outs["static"] == outs["bucket"]


@pytest.mark.parametrize("tail,K,nw", [("forward", 14, 37), ("reverse", 12, 5)])
def test_rawcount_writer_matches_pandas(tmp_path, tail, K, nw):
    """The csv-module rawcount writer emits exactly pandas.to_csv's bytes
    (the reference's writer): LF endings, empty index label, header."""
    pd = pytest.importorskip("pandas")
    from types import SimpleNamespace

    rng = np.random.default_rng(K)
    kmers = ["".join(rng.choice(list("ACGT"), 5)) for _ in range(K)]
    counts = rng.integers(1, 30, (K, nw)).astype(np.int32)
    eng = JaxEngine(TopsicleConfig(input_dir="x", output_dir=str(tmp_path),
                                   pattern="CCCTAAA", slide=7))
    eng._write_rawcount(SimpleNamespace(tail=tail), SimpleNamespace(kmers=kmers),
                        counts, 5, 1)
    pd.DataFrame({
        "tail": np.repeat(tail, nw * K),
        "position": np.repeat(np.arange(nw) * 7, K),
        "pattern": np.tile(np.asarray(kmers, dtype=object), nw),
        "count": counts.T.reshape(-1),
    }).to_csv(tmp_path / "want.csv")
    assert (tmp_path / "rawcount_5_1.csv").read_bytes() == \
        (tmp_path / "want.csv").read_bytes()


@pytest.mark.parametrize("plot", [False, True])
def test_missing_matplotlib_logs_one_line(tmp_path, monkeypatch, plot):
    """Without matplotlib the run completes and says so once, with no
    exception text; the outputs are unchanged."""
    from topsicle_tpu import plots

    monkeypatch.setattr(plots, "matplotlib_available", lambda: False)
    rng = random.Random(5)
    data = tmp_path / "s.fastq.gz"
    _write_synthetic_fastq(str(data), rng, n_reads=24)
    JaxEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "j"),
                             pattern="CCCTAAA", slide=6, batch_size=8,
                             plot=plot)).run()
    log = (tmp_path / "j" / "topsicle_run.log").read_text()
    assert log.count(plots.SKIPPED) == 1
    assert "plot failed" not in log
    assert not list((tmp_path / "j").glob("*.png"))
    OracleEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "o"),
                                pattern="CCCTAAA", slide=6)).run()
    assert (tmp_path / "j" / "telolengths_all.csv").read_bytes() == \
        (tmp_path / "o" / "telolengths_all.csv").read_bytes()

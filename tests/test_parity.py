"""Behavioral parity details: log line sequence, cutoff-list semantics,
FASTA inputs, and the engine-vs-oracle contract on them."""

import gzip
import random

import pytest

from tests.conftest import requires_demo

from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.oracle import OracleEngine
from topsicle_tpu.pipeline import JaxEngine


def _telo_read(rng, pattern, telo_len, total):
    telo = (pattern * (telo_len // len(pattern) + 1))[:telo_len]
    rest = "".join(rng.choice("ACGT") for _ in range(total - telo_len))
    return telo + rest


def _write_fasta(path, rng, n=8, pattern="CCCTAAA"):
    with open(path, "w") as fh:
        for i in range(n):
            seq = _telo_read(rng, pattern, rng.randrange(300, 3000), 12000)
            fh.write(f">fa{i} desc\n")
            for j in range(0, len(seq), 70):
                fh.write(seq[j : j + 70] + "\n")


def test_fasta_input_engine_vs_oracle(tmp_path):
    rng = random.Random(11)
    data = tmp_path / "reads.fasta"
    _write_fasta(str(data), rng)
    JaxEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "j"),
                             pattern="CCCTAAA", slide=6, batch_size=8)).run()
    OracleEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "o"),
                                pattern="CCCTAAA", slide=6)).run()
    assert (tmp_path / "j" / "telolengths_all.csv").read_bytes() == \
           (tmp_path / "o" / "telolengths_all.csv").read_bytes()
    # subset of a .fasta input is a .fasta file
    subs = list((tmp_path / "j").glob("*_trc_over_*.fasta"))
    assert len(subs) == 1
    assert (tmp_path / "o" / subs[0].name).read_bytes() == subs[0].read_bytes()


def test_cutoff_list_semantics(tmp_path):
    """min(cutoff) filters step 1; cutoff[0] anchors the quad fit
    (main.py:56,254-257)."""
    cfg = TopsicleConfig(input_dir="x", output_dir="y", pattern="CCCTAAA",
                         cutoff=[0.9, 0.5, 0.7])
    assert cfg.min_cutoff() == 0.5
    assert cfg.input_trc() == 0.9


def test_slide_zero_falls_back_to_pattern_length():
    cfg = TopsicleConfig(input_dir="x", output_dir="y", pattern="CCCTAAA", slide=0)
    assert cfg.slide_value() == 7  # reference truthiness quirk, replicated


@requires_demo
def test_cli_log_line_sequence(demo_fastq, tmp_path, capsys):
    """The reference's observable log line sequence (README.md:272 greps
    the completion sentinel; topsicle_run.log:17-28 shows the shape)."""
    from topsicle_tpu.cli import main

    rc = main([
        "--inputDir", demo_fastq, "--outputDir", str(tmp_path),
        "--pattern", "CCCTAAA", "--slide", "6", "--batchSize", "8",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    expected_order = [
        "---- Topsicle run parameters ---",
        "pattern: CCCTAAA",
        "Starting Topsicle analysis",
        "No telophrase provided, use kmer: [5]",
        "Output will be here:",
        "patterns to search: ['AAACC', 'AACCC', 'ACCCT', 'CCCTA', 'CCTAA', "
        "'CTAAA', 'TAAAC', 'TTTGG', 'TTGGG', 'TGGGA', 'GGGAT', 'GGATT', "
        "'GATTT', 'ATTTG']",
        "begin processing reads",
        "subsetting raw dataset based on TRC cutoff",
        "Temporary fasta file with TRC more than 0.7:",
        "finished processing all reads",
        "k-mer: 5, with TRC >= 0.7, median telomere length is 2110.00 bp",
        "asymptotic TRC, or recommended cutoff: 0.897",
        "Median telomere length for reads with TRC cutoff >= 0.897: 2050.00 bp",
        "All telomere found, have a nice day.",
        "Elapsed time(s):",
    ]
    pos = 0
    for marker in expected_order:
        found = out.find(marker, pos)
        assert found >= 0, f"missing or out of order: {marker!r}"
        pos = found


def test_prefetch_iterator_order_and_errors():
    from topsicle_tpu.utils.prefetch import prefetch

    assert list(prefetch(range(100), depth=3)) == list(range(100))

    def boom():
        yield 1
        raise RuntimeError("inner")

    it = prefetch(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError):
        list(it)


def test_multi_k_subset_reuse(tmp_path):
    """Second telophrase reuses the first's subset file (main.py:65-66)
    without crashing on pass-set differences (reference would IndexError
    — SURVEY.md engine note)."""
    rng = random.Random(12)
    data = tmp_path / "r.fastq.gz"
    with gzip.open(data, "wt") as fh:
        for i in range(6):
            seq = _telo_read(rng, "CCCTAA", rng.randrange(500, 3000), 11000)
            fh.write(f"@m{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    cfg = TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "o"),
                         pattern="CCCTAA", telophrase=[4, 5], batch_size=8)
    res = JaxEngine(cfg).run()
    subsets = list((tmp_path / "o").glob("*_trc_over_*.fastq"))
    assert len(subsets) == 1  # one shared subset file across k values


def test_human_pattern_multi_k_sweep(tmp_path):
    """BASELINE config 3: human CCCTAA (6 bp) with a telophrase sweep
    {4,5,6} and a cutoff list — engine CSV byte-equal to the oracle's."""
    rng = random.Random(23)
    data = tmp_path / "human.fastq.gz"
    with gzip.open(str(data), "wt") as fh:
        for i in range(10):
            # mix: telomeric start, telomeric (reversed) end, random
            kind = i % 3
            seq = _telo_read(rng, "CCCTAA", rng.randrange(400, 3500), 11000)
            if kind == 1:
                seq = seq[::-1]
            elif kind == 2:
                seq = "".join(rng.choice("ACGT") for _ in range(11000))
            fh.write(f"@hr{i}\n{seq}\n+\n{'F'*len(seq)}\n")
    kw = dict(pattern="CCCTAA", telophrase=[4, 5, 6], cutoff=[0.7, 0.8],
              min_seq_length=9000)
    JaxEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "j"),
                             batch_size=4, **kw)).run()
    OracleEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / "o"),
                                **kw)).run()
    j = (tmp_path / "j" / "telolengths_all.csv").read_bytes()
    o = (tmp_path / "o" / "telolengths_all.csv").read_bytes()
    assert j == o
    assert j.count(b"\r\n") > 3 * 3  # rows for each k


def test_multi_file_readahead_matches_oracle(tmp_path):
    """Cross-file read-ahead (--threads default) must not reorder or
    drop rows: 3 input files, engine CSV byte-equal to oracle's, and
    byte-equal to a --threads 1 (no read-ahead) run."""
    rng = random.Random(31)
    d = tmp_path / "data"
    d.mkdir()
    for f in range(3):
        _write_fasta(str(d / f"f{f}.fasta"), rng, n=5)
    kw = dict(pattern="CCCTAAA", slide=6)
    JaxEngine(TopsicleConfig(input_dir=str(d), output_dir=str(tmp_path / "j"),
                             batch_size=4, **kw)).run()
    JaxEngine(TopsicleConfig(input_dir=str(d), output_dir=str(tmp_path / "j1"),
                             batch_size=4, threads=1, **kw)).run()
    OracleEngine(TopsicleConfig(input_dir=str(d), output_dir=str(tmp_path / "o"),
                                **kw)).run()
    j = (tmp_path / "j" / "telolengths_all.csv").read_bytes()
    assert j == (tmp_path / "o" / "telolengths_all.csv").read_bytes()
    assert j == (tmp_path / "j1" / "telolengths_all.csv").read_bytes()


def test_randomized_param_fuzz_engine_vs_oracle(tmp_path):
    """Fuzz the full (pattern, k, windowSize, slide, trimfirst,
    maxlengthtelo, minSeqLength, cutoff) space on synthetic reads with
    N bases and ragged lengths: engine CSV must equal the oracle's byte
    for byte in every drawn config."""
    rng = random.Random(20260820)
    patterns = ["CCCTAAA", "CCCTAA", "TTAGGG", "ACGGT"]
    for trial in range(4):
        pattern = patterns[trial]
        data = tmp_path / f"in{trial}"
        data.mkdir()
        with gzip.open(data / "r.fastq.gz", "wt") as fh:
            for i in range(10):
                total = rng.randrange(4000, 9000)
                telo_len = rng.randrange(100, 2500)
                seq = list(_telo_read(rng, pattern, telo_len, total))
                for _ in range(rng.randrange(0, 6)):     # sprinkle Ns
                    seq[rng.randrange(total)] = "N"
                if rng.random() < 0.5:                   # reverse-end telo
                    seq = seq[::-1]
                s = "".join(seq)
                fh.write(f"@r{trial}_{i}\n{s}\n+\n{'I' * len(s)}\n")
        kw = dict(
            pattern=pattern,
            telophrase=[rng.choice([3, 4, 5, len(pattern) - 1, len(pattern)])],
            window_size=rng.choice([60, 100, 147]),
            slide=rng.choice([3, 6, 11]),
            trimfirst=rng.choice([0, 50, 100]),
            maxlengthtelo=rng.choice([3000, 5000, 20000]),
            min_seq_length=3500,
            cutoff=rng.choice([0.3, [0.5, 0.3]]),
        )
        JaxEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / f"j{trial}"),
                                 batch_size=8, **kw)).run()
        OracleEngine(TopsicleConfig(input_dir=str(data), output_dir=str(tmp_path / f"o{trial}"),
                                    **kw)).run()
        got = (tmp_path / f"j{trial}" / "telolengths_all.csv").read_bytes()
        want = (tmp_path / f"o{trial}" / "telolengths_all.csv").read_bytes()
        assert got == want, f"trial {trial}: {kw}"

"""Native C++ IO library vs the pure-Python reader (bit-identical
contract on real and synthetic inputs)."""

import gzip

import numpy as np
import pytest

from tests.conftest import requires_demo

from topsicle_tpu.io import batch as batching
from topsicle_tpu.io import reader

native = pytest.importorskip("topsicle_tpu.native")

pytestmark = pytest.mark.skipif(
    not native.native_available(), reason="C++ toolchain/zlib unavailable"
)


def _python_reads(path, min_len):
    return [
        (rec.id, batching.encode_read(rec.seq))
        for rec in reader.parse_records(path)
        if len(rec.seq) > min_len
    ]


@requires_demo
def test_native_matches_python_on_demo(demo_fastq):
    want = _python_reads(demo_fastq, 9000)
    got = list(native.NativeReader(demo_fastq, 9000))
    assert len(got) == len(want)
    for (wid, wc), (gid, gc) in zip(want, got):
        assert gid == wid
        np.testing.assert_array_equal(gc, wc)


def test_native_fasta_gz(tmp_path):
    p = tmp_path / "x.fasta.gz"
    with gzip.open(p, "wt") as fh:
        fh.write(">r1 desc here\nACGTN\nacgt\n>r2\nTT\n>r3\n" + "CCCTAAA" * 30 + "\n")
    want = _python_reads(str(p), 5)
    got = list(native.NativeReader(str(p), 5))
    assert [g[0] for g in got] == [w[0] for w in want] == ["r1", "r3"]
    for (wid, wc), (gid, gc) in zip(want, got):
        np.testing.assert_array_equal(gc, wc)


def test_native_plain_fastq(tmp_path):
    p = tmp_path / "x.fastq"
    p.write_text("@a 1\nACGT\n+\nIIII\n@b 2\nNNNNNNNN\n+b\nIIIIIIII\n")
    got = list(native.NativeReader(str(p), 3))
    assert [g[0] for g in got] == ["a", "b"]
    assert got[0][1].tolist() == [0, 1, 2, 3]
    assert got[1][1].tolist() == [4] * 8


@requires_demo
def test_native_subset_bytes(demo_fastq, demo_subset, tmp_path):
    with open(demo_subset) as fh:
        want = fh.read()
    keep = sorted({line[1:].split()[0] for line in want.splitlines()[::4]})
    out = tmp_path / "sub.fastq"
    n = native.write_subset_native(demo_fastq, str(out), keep, True)
    assert n == 17
    assert out.read_text() == want


def test_native_subset_fasta_wrap(tmp_path):
    p = tmp_path / "x.fastq"
    p.write_text(f"@a 1\n{'A' * 130}\n+\n{'I' * 130}\n")
    out = tmp_path / "sub.fasta"
    native.write_subset_native(str(p), str(out), ["a"], False)
    lines = out.read_text().splitlines()
    assert lines[0] == ">a 1"
    assert [len(x) for x in lines[1:]] == [60, 60, 10]


@requires_demo
def test_engine_native_vs_python_csv(demo_fastq, demo_csv, tmp_path):
    from topsicle_tpu.config import TopsicleConfig
    from topsicle_tpu.pipeline import JaxEngine

    cfg = TopsicleConfig(
        input_dir=demo_fastq, output_dir=str(tmp_path), pattern="CCCTAAA",
        slide=6, batch_size=8, native_io=True,
    )
    JaxEngine(cfg).run()
    with open(demo_csv, "rb") as fh:
        assert (tmp_path / "telolengths_all.csv").read_bytes() == fh.read()

def test_library_is_built_from_committed_source():
    """The loaded library sits in the ignored build dir under a name
    keyed by the hash of tsio.cc."""
    import hashlib
    import os

    from topsicle_tpu.native import loader

    with open(loader._SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    path = loader.library_path()
    assert os.path.basename(path) == f"_tsio-{digest}.so"
    assert os.path.dirname(path) == loader._BUILD_DIR
    assert os.path.exists(path)


def test_build_ignores_binaries_of_other_sources(tmp_path, monkeypatch):
    """A binary that is not keyed by the current source (an old
    `_tsio.so`, however new its mtime) is never reused; a matching one
    is reused without compiling."""
    import subprocess

    from topsicle_tpu.native import loader

    src = tmp_path / "tsio.cc"
    src.write_bytes(open(loader._SRC, "rb").read())
    build = tmp_path / "build"
    build.mkdir()
    (build / "_tsio.so").write_bytes(b"stale")
    monkeypatch.setattr(loader, "_SRC", str(src))
    monkeypatch.setattr(loader, "_BUILD_DIR", str(build))
    compiles = []

    def fake_compile(cmd, **kw):
        compiles.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as fh:
            fh.write(b"built")

    monkeypatch.setattr(subprocess, "run", fake_compile)
    first = loader._build()
    assert len(compiles) == 1 and open(first, "rb").read() == b"built"
    assert loader._build() == first and len(compiles) == 1
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert loader._build() != first and len(compiles) == 2

"""True multi-host validation on CPU: two OS processes joined by
jax.distributed (gloo), each with 4 virtual CPU devices, forming one
8-device global mesh.  --shardMode global shards every batch over all
devices of both processes (GSPMD inserts the cross-process collectives
— NCCL between cards on a real machine) and the merged CSV must be byte-identical
to a single-process run."""

import gzip
import os
import random
import socket
import subprocess
import sys

from topsicle_tpu.config import TopsicleConfig
from topsicle_tpu.pipeline import JaxEngine


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_file(path, rng, n):
    pat = "CCCTAAA"
    with gzip.open(path, "wt") as fh:
        for i in range(n):
            tl = rng.randrange(400, 3000)
            telo = (pat * (tl // len(pat) + 1))[:tl]
            seq = telo + "".join(rng.choice("ACGT") for _ in range(11000 - tl))
            if i % 3 == 1:
                seq = seq[::-1]
            fh.write(f"@{os.path.basename(path)}_r{i}\n{seq}\n+\n{'I'*len(seq)}\n")


def test_files_mode_two_processes_jax_distributed(tmp_path):
    """--shardMode files with a jax.distributed world: each process
    must shard over its ADDRESSABLE devices only (round-5 regression:
    the engine once built the shard mesh over jax.devices() — all 8
    global — and the first result fetch died with 'spans
    non-addressable devices').  Merged CSV byte-identical to a
    single-process run."""
    rng = random.Random(62)
    d = tmp_path / "in"
    d.mkdir()
    for i in range(4):
        _write_file(str(d / f"f{i}.fastq.gz"), rng, 4)

    single = tmp_path / "single"
    JaxEngine(TopsicleConfig(input_dir=str(d), output_dir=str(single),
                             pattern="CCCTAAA", slide=6, batch_size=8)).run()
    want = (single / "telolengths_all.csv").read_bytes()

    multi = tmp_path / "multi"
    port = _free_port()
    script = (
        "import os, sys\n"
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from topsicle_tpu.cli import main\n"
        "sys.exit(main(['--inputDir', {ind!r}, '--outputDir', {outd!r},\n"
        "  '--pattern', 'CCCTAAA', '--slide', '6', '--batchSize', '8',\n"
        "  '--shardMode', 'files', '--coordinator', '127.0.0.1:{port}',\n"
        "  '--processId', {pid!r}, '--processCount', '2']))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             script.format(ind=str(d), outd=str(multi), pid=str(pid), port=port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in (0, 1)
    ]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-3000:]
    got = (multi / "telolengths_all.csv").read_bytes()
    assert got == want


def test_global_mesh_two_processes(tmp_path):
    rng = random.Random(61)
    d = tmp_path / "in"
    d.mkdir()
    # skewed inputs: the whole point of global mode is that process 1's
    # chips still help when process 0 holds most of the reads
    _write_file(str(d / "big.fastq.gz"), rng, 9)
    _write_file(str(d / "small.fastq.gz"), rng, 3)

    single = tmp_path / "single"
    JaxEngine(TopsicleConfig(input_dir=str(d), output_dir=str(single),
                             pattern="CCCTAAA", slide=6, batch_size=8)).run()
    want = (single / "telolengths_all.csv").read_bytes()

    multi = tmp_path / "multi"
    port = _free_port()
    script = (
        "import os, sys\n"
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from topsicle_tpu.cli import main\n"
        "sys.exit(main(['--inputDir', {ind!r}, '--outputDir', {outd!r},\n"
        "  '--pattern', 'CCCTAAA', '--slide', '6', '--batchSize', '8',\n"
        "  '--shardMode', 'global', '--coordinator', '127.0.0.1:{port}',\n"
        "  '--processId', {pid!r}, '--processCount', '2']))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             script.format(ind=str(d), outd=str(multi), pid=str(pid), port=port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in (0, 1)
    ]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-3000:]
    got = (multi / "telolengths_all.csv").read_bytes()
    assert got == want
    assert not (multi / ".parts").exists()

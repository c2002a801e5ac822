"""Ahead-of-time warming (`topsicle --precompile`) and the persistent
compilation cache it fills (utils/compile_cache.py).

The cache lives where JAX_COMPILATION_CACHE_DIR says, else at a fixed
path inside the checkout; --precompile compiles every program a
configuration uses into it, so later processes load instead of compile.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax._src import compilation_cache

from topsicle_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_HITS = "/jax/compilation_cache/cache_hits"


@pytest.fixture
def jax_cache(tmp_path, monkeypatch):
    """A private persistent cache for this test; the process's previous
    cache settings come back afterwards."""
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {n: getattr(jax.config, n) for n in names}
    d = tmp_path / "jax_cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(d))
    compilation_cache.reset_cache()
    yield d
    for n, v in saved.items():
        jax.config.update(n, v)
    compilation_cache.reset_cache()


def _entries(d) -> int:
    return sum(len(f) for _, _, f in os.walk(d)) if os.path.isdir(d) else 0


def test_precompile_warms_every_program(jax_cache, tmp_path):
    """`topsicle --precompile` compiles both stages in both wire formats
    (and rawcounts when flagged) into the persistent cache; a fresh
    model then loads every one of them from it."""
    from topsicle_tpu.config import TopsicleConfig
    from topsicle_tpu.io import batch as batching
    from topsicle_tpu.io.writer import RunLog
    from topsicle_tpu.kmers import telophrase_kmers
    from topsicle_tpu.models import TelomereScanModel
    from topsicle_tpu.parallel import ShardedScanModel, data_mesh
    from topsicle_tpu.pipeline import JaxEngine

    assert compile_cache.enable_compilation_cache() == str(jax_cache)
    cfg = TopsicleConfig(
        input_dir=str(tmp_path), output_dir=str(tmp_path / "o"),
        pattern="CCCTAAA", slide=6, batch_size=8, maxlengthtelo=1100,
        rawcountpattern=True)
    with compile_cache.count_compiled_programs() as names:
        n = JaxEngine(cfg, log=RunLog(None, echo=False)).precompile()
    # the test mesh has 8 virtual devices, so the engine's stage programs
    # are the shard_map variants (step 1 and step 2, lean and dense);
    # rawcounts (lean and dense) stays on the base model.  Fetching
    # sharded results compiles JAX's own small gather programs too.
    assert n == len(names) >= 6
    for prog in ("_step1_counts_lean", "_step1_counts",
                 "_step2_boundary_lean", "_step2_boundary"):
        assert f"jit({prog})" in names
    assert _entries(jax_cache) >= 6

    hits = []

    def listener(event, **kwargs):
        if event == _CACHE_HITS:
            hits.append(event)

    jax.monitoring.register_event_listener(listener)
    try:
        m = ShardedScanModel(
            TelomereScanModel(telophrase_kmers("CCCTAAA", 5), slide=6),
            mesh=data_mesh(8))
        B = 8
        ends = np.zeros((B, 2, 1000), np.uint8)
        el = np.full(B, 1000, np.int32)
        m.step1_counts(ends, el)
        dirty = ends.copy()
        dirty[0, 0, 0] = 0xFF
        m.step1_counts(dirty, el)
        L = 1024
        tails = np.zeros((B, L), np.uint8)
        lens = np.full(B, L, np.int32)
        nw = batching.window_counts_for_lengths(lens, 100, 6)
        m.step2_boundary(tails, nw, lens)
        dt = tails.copy()
        dt[0, 0] = 0xFF
        m.step2_boundary(dt, nw, lens)
        m.rawcounts(tails, lens)
        m.rawcounts(dt, lens)
    finally:
        jax.monitoring.unregister_event_listener(listener)
    assert len(hits) == 6


def test_precompile_cli_flag(jax_cache, tmp_path):
    from topsicle_tpu.cli import main as cli_main

    rc = cli_main([
        "--inputDir", str(tmp_path), "--outputDir", str(tmp_path / "o"),
        "--pattern", "CCCTAAA", "--slide", "6", "--batchSize", "8",
        "--maxlengthtelo", "1100", "--precompile"])
    assert rc == 0
    assert _entries(jax_cache) > 0
    log = (tmp_path / "o" / "topsicle_run.log").read_text()
    assert f"compile cache: {jax_cache}" in log
    assert re.search(r"precompiled [1-9][0-9]* device programs into "
                     + re.escape(str(jax_cache)), log)


def test_count_compiled_programs_counts_each_program_once():
    f = jax.jit(lambda x: x * 3 + 1)
    with compile_cache.count_compiled_programs() as names:
        f(np.ones(5, np.int32))
        f(np.ones(5, np.int32))            # same shape: no new program
        f(np.ones(6, np.int32))
    assert len(names) == 2


def test_cache_dir_honours_env_var(tmp_path):
    """JAX_COMPILATION_CACHE_DIR decides, in a fresh process, and JAX
    writes its entries there."""
    d = tmp_path / "elsewhere"
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, numpy as np\n"
         "from topsicle_tpu.utils.compile_cache import enable_compilation_cache\n"
         "print(enable_compilation_cache())\n"
         "jax.jit(lambda x: x + 1)(np.ones(3))\n"],
        env=dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(d),
                 JAX_PLATFORMS="cpu", PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == str(d)
    assert _entries(d) > 0


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert compile_cache.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_cache_dir_same_across_processes_and_cwds(tmp_path):
    """Two processes started from two working directories resolve the
    same path: no cwd, temp name, pid or time enters it."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    seen = []
    for cwd in (tmp_path, REPO):
        out = subprocess.run(
            [sys.executable, "-c",
             "from topsicle_tpu.utils.compile_cache import cache_dir\n"
             "print(cache_dir())"],
            env=env, capture_output=True, text=True, timeout=120, cwd=str(cwd))
        assert out.returncode == 0, out.stderr[-2000:]
        seen.append(out.stdout.strip())
    assert seen[0] == seen[1] == os.path.join(REPO, ".jax_cache")

"""Multi-chip sharding on the virtual 8-device CPU mesh: sharded results
must be bit-identical to single-device results, and the driver entry
points must compile and run."""

import numpy as np
import pytest

import jax

from topsicle_tpu.io import batch as batching
from topsicle_tpu.kmers import telophrase_kmers
from topsicle_tpu.models import TelomereScanModel
from topsicle_tpu.parallel import ShardedScanModel, data_mesh


@pytest.fixture(scope="module")
def models():
    base = TelomereScanModel(telophrase_kmers("CCCTAAA", 5), window_size=100, slide=6)
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    sharded = ShardedScanModel(base, mesh=data_mesh(8))
    return base, sharded


def _random_batch(rng, B, L):
    return rng.integers(0, 6, (B, L), dtype=np.uint8)  # includes invalid codes


def test_sharded_step1_bit_identical(models):
    base, sharded = models
    rng = np.random.default_rng(3)
    ends = rng.integers(0, 6, (16, 2, 1000), dtype=np.uint8)
    np.testing.assert_array_equal(base.step1_counts(ends), sharded.step1_counts(ends))


def test_sharded_step2_bit_identical(models):
    base, sharded = models
    rng = np.random.default_rng(4)
    B, L = 16, 2048
    tails = _random_batch(rng, B, L)
    lens = rng.integers(100, L, B).astype(np.int32)
    for i in range(B):
        tails[i, lens[i]:] = 0xFF
    n = batching.window_counts_for_lengths(lens, 100, 6)
    t0, h0 = base.step2_boundary(tails, n)
    t1, h1 = sharded.step2_boundary(tails, n)
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(h0, h1)


def test_mesh_batch_divisibility_guard(models):
    _, sharded = models
    ends = np.zeros((9, 2, 1000), np.uint8)
    with pytest.raises(AssertionError):
        sharded.step1_counts(ends)


def test_graft_entry_single_chip():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    counts, t, has = out
    assert counts.shape[0] == args[0].shape[0]


def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_sharded_lean_bit_identical(models):
    """Lean wire format through shard_map == dense single-chip results."""
    base, sharded = models
    rng = np.random.default_rng(7)
    B, no_bp = 16, 1000
    # clean batches (codes 0..3 only) with ragged lengths
    ends = rng.integers(0, 4, (B, 2, no_bp), dtype=np.uint8)
    ends_len = rng.integers(200, no_bp + 1, B).astype(np.int32)
    for i in range(B):  # suffix-pad beyond the valid length
        ends[i, :, ends_len[i]:] = 0xFF
    np.testing.assert_array_equal(
        base.step1_counts(ends), sharded.step1_counts(ends, ends_len)
    )

    L = 2048
    tails = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lens = rng.integers(150, L + 1, B).astype(np.int32)
    for i in range(B):
        tails[i, lens[i]:] = 0xFF
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    t0, h0 = base.step2_boundary(tails, nw)
    t1, h1 = sharded.step2_boundary(tails, nw, lens)
    np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))
    np.testing.assert_array_equal(np.asarray(h0), np.asarray(h1))

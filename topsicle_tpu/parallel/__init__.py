"""Multi-chip / multi-host scale-out.

The reference's only parallelism is a fork pool over input files plus a
manual SLURM convention (SURVEY.md §2.3).  Here the scaling axis is
reads: a 1-D device mesh with shard_map data parallelism over the batch
dimension, XLA collectives for result gathering (NCCL between cards),
and deterministic global row ordering so N-card output is byte-identical
to 1-card output."""

from topsicle_tpu.parallel.mesh import data_mesh, local_device_count  # noqa: F401
from topsicle_tpu.parallel.sharding import ShardedScanModel  # noqa: F401

"""topsicle-tpu: a JAX telomere-boundary engine for GPUs.

A from-scratch re-design (JAX / XLA / shard_map) with capability
parity with the reference CPU tool Topsicle (see SURVEY.md at the repo
root).  The compute path is pure-integer on device: 2-bit-class base codes,
k-mer rolling-code matching, greedy non-overlap counting, and an exact
integer Binseg-L2 changepoint — so device results are bit-stable across
chips, meshes, and batch orders.

Layout:
    topsicle_tpu.oracle    pure-Python (stdlib+numpy) reference semantics
    topsicle_tpu.io        host input pipeline (FASTA/FASTQ(.gz) -> codes)
    topsicle_tpu.ops       device ops (match/TRC/windows/changepoint)
    topsicle_tpu.models    the fused device programs ("models")
    topsicle_tpu.parallel  mesh construction + shard_map data parallelism
    topsicle_tpu.utils     logging / profiling helpers

This module intentionally does NOT import jax; importing the oracle or the
host IO layer stays accelerator-free.  Device modules live under
`topsicle_tpu.ops` / `topsicle_tpu.models` and enable 64-bit mode on import
(the changepoint argmax uses exact int64/uint64 limb arithmetic).
"""

__version__ = "0.1.0"

from topsicle_tpu.config import TopsicleConfig  # noqa: F401

"""Runtime utilities: stage profiling, throughput counters, run
manifest, persistent compile cache."""

from topsicle_tpu.utils.profiling import StageTimers, trace_context  # noqa: F401
from topsicle_tpu.utils.manifest import RunManifest  # noqa: F401
from topsicle_tpu.utils.compile_cache import enable_compilation_cache  # noqa: F401

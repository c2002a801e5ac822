"""Test harness configuration.

Device tests run on a virtual 8-device CPU mesh (no GPU needed):
JAX_PLATFORMS=cpu + xla_force_host_platform_device_count=8 must be set
BEFORE jax is first imported, which is why this lives at conftest import
time (SURVEY.md §4: multi-host logic is testable on CPU devices)."""

import os

# Force CPU even on a machine with a GPU: tests model multi-device
# behavior on a virtual CPU mesh and must never contend for the card.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# The config update below (before any backend initialization) wins over
# anything that set jax_platforms at interpreter start.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# Reference demo fixtures (read-only mount).  Tests that need them skip
# cleanly when the mount is absent.
REFERENCE_ROOT = "/root/reference"
DEMO_FASTQ = os.path.join(
    REFERENCE_ROOT,
    "Topsicle_demo/data_col0_teloreg_chr/Col-0-6909_GWHBDNP00000001.1_nano_right.fastq.gz",
)
DEMO_CSV = os.path.join(REFERENCE_ROOT, "Topsicle_demo/telolengths_all.csv")
DEMO_SUBSET = os.path.join(
    REFERENCE_ROOT,
    "Topsicle_demo/result_justone/Col-0-6909_GWHBDNP00000001.1_nano_right.fastq_trc_over_0.7.fastq",
)

requires_demo = pytest.mark.skipif(
    not os.path.exists(DEMO_FASTQ), reason="reference demo data not mounted"
)


@pytest.fixture
def demo_fastq():
    return DEMO_FASTQ


@pytest.fixture
def demo_csv():
    return DEMO_CSV


@pytest.fixture
def demo_subset():
    return DEMO_SUBSET

"""Host-side visualization (matplotlib), reference-parity figures:

- per-read changepoint plot (--plot; allsteps.py:316-328)
- quadratic-fit plot (allsteps.py:486-500)
- descriptive match-position plot and k-mer/match heatmap live in
  topsicle_tpu.plots.overview (descriptive_plot.py:89-165,233-313)
"""

import importlib.util

from topsicle_tpu.plots.figures import changepoint_plot, quadfit_plot  # noqa: F401

SKIPPED = "matplotlib not installed; plot skipped"


def matplotlib_available() -> bool:
    """matplotlib is optional: runs without it skip their figures."""
    return importlib.util.find_spec("matplotlib") is not None

"""batch_gcups: true cells (sum of m * n) of the calls resolved in the
window, over the window (Gcells/s)."""

from benchmark.harness.readers import gcups as read  # noqa: F401

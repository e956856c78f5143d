"""Port of :mod:`apex_tpu.utils` (the tree helpers amp needs)."""

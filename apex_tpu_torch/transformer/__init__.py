"""Port of :mod:`apex_tpu.transformer` (the tensor-parallel layers at tp=1,
the enums, and ``functional.FusedScaleMaskSoftmax``)."""

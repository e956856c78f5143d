"""Port of :mod:`apex_tpu.ops`: each op's plain PyTorch version beside the
hand-written CUDA kernel that replaces its Pallas kernel."""

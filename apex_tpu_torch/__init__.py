"""apex_tpu_torch: the PyTorch/CUDA port of :mod:`apex_tpu` for NVIDIA Hopper.

The JAX package ``apex_tpu`` stays the reference; this package mirrors its
module paths (``apex_tpu_torch/serving/engine.py`` is the counterpart of
``apex_tpu/serving/engine.py``) and is held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and numpy only
— never ``jax`` and nothing of ``apex_tpu`` — so it runs on a machine that
has no JAX.

Every Pallas kernel on a ported path becomes a hand-written CUDA kernel for
``sm_90a`` under ``apex_tpu_torch/csrc/``, built with ``nvcc`` at first use
(:mod:`apex_tpu_torch.ops._build`). Beside each kernel sits its plain
PyTorch version: a CPU tensor takes the plain version, a CUDA tensor takes
the kernel or the call raises (:mod:`apex_tpu_torch.ops._backend`).

Ported so far: the serving path — :class:`~apex_tpu_torch.serving.engine.
ServingEngine` over :class:`~apex_tpu_torch.models.gpt.GPTModel`, with the
paged decode-attention and fused-sampling kernels.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Dict, Optional

import torch


def _run(cmd) -> Optional[str]:
    """stdout of ``cmd``, or None when the tool is missing or fails."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def nvcc_path() -> Optional[str]:
    """The CUDA compiler the kernel build uses: ``$CUDA_HOME/bin/nvcc``
    (default ``/usr/local/cuda``), else the first ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    return shutil.which("nvcc")


def env_report() -> Dict[str, Optional[str]]:
    """The toolchain and card this process runs on: torch and its CUDA
    build, the ``nvcc`` release, the GPU's name, and the name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (a card below its maximum power
    runs slower under load, so every timing is reported beside it).
    Fields that do not apply on this machine are None."""
    nvcc = nvcc_path()
    nvcc_version = None
    if nvcc is not None:
        out = _run([nvcc, "--version"])
        m = re.search(r"release ([0-9.]+)", out or "")
        nvcc_version = m.group(1) if m else out
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc_version,
        "gpu": (torch.cuda.get_device_name(0)
                if torch.cuda.is_available() else None),
        "nvidia_smi": smi.splitlines()[0] if smi else None,
    }

"""Kernel dispatch: the tensor's device decides, and nothing else.

Replaces ``apex_tpu/ops/_backend.py:64-80`` (``choose_impl``), whose
``auto`` weighed the JAX backend, per-op tiling rules and an environment
override. Here the rule has no escape hatch:

* a CPU tensor runs the op's plain PyTorch version;
* a CUDA tensor runs the op's hand-written kernel, or the call raises —
  there is no ``try`` that falls back and no environment switch;
* ``impl="torch"`` selects the plain version on any device. It exists for
  the tests and ``chip_smoke.py``, which hold each kernel against its plain
  version on the card, and is never a default.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

IMPLS = ("auto", "torch")


def use_kernel(x: torch.Tensor, impl: str = "auto") -> bool:
    """True when ``x`` must go through the op's CUDA kernel."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "torch" or x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(
        f"no kernel or plain version for device {x.device}: the port runs "
        f"on CUDA (kernels) or the CPU (plain versions)")


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """An entry point's device: ``None`` means the card. A CUDA device
    with no card present raises — an entry point never drops to the CPU
    on its own; a caller that wants the CPU says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apex_tpu_torch entry points run on a CUDA device by default "
            "and torch.cuda.is_available() is False here — pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev

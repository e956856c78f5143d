"""Rank information for the monitor's records.

Port of the rank half of ``apex_tpu/utils/logging.py``. One Python process
drives one card here, so "rank" is (:func:`process_index`, the rank-info
string a caller registers with :func:`set_rank_info`). The process index is
``torch.distributed``'s rank when a process group is initialised, else 0;
the monitor's registry stamps both on every record
(:mod:`apex_tpu_torch.monitor.registry`). The logger factory comes with the
first module of the port that logs.
"""

from __future__ import annotations

_RANK_INFO: str = ""


def set_rank_info(info: str) -> None:
    """Record a short rank descriptor (e.g. ``"dp0/tp1/pp0"``) for records."""
    global _RANK_INFO
    _RANK_INFO = info


def get_rank_info() -> str:
    return _RANK_INFO


def process_index() -> int:
    """This process's index: ``torch.distributed.get_rank()`` when a
    process group is initialised, else 0. Reading it never initialises a
    group (a record must not be what starts one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


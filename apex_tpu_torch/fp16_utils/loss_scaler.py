"""The legacy ``LossScaler`` and ``DynamicLossScaler``.

Port of ``apex_tpu/fp16_utils/loss_scaler.py:17-63``: host-side objects
holding the scale as a Python float. :class:`LossScaler` is static: its
``has_overflow`` is always False. :class:`DynamicLossScaler` starts at
2**16, halves the scale on an overflow (never below 1.0) and doubles it
after ``scale_window`` (2000) overflow-free steps; its ``has_overflow``
reads :func:`apex_tpu_torch.amp.scaler.all_finite` on the host.
"""

from __future__ import annotations

from apex_tpu_torch.amp.scaler import all_finite
from apex_tpu_torch.utils.pytree import tree_map


class LossScaler:
    """A fixed scale."""

    def __init__(self, scale: float = 1.0):
        self._scale = float(scale)

    @property
    def loss_scale(self) -> float:
        return self._scale

    def scale_gradient(self, grads):
        return tree_map(lambda g: g * self._scale, grads)

    def unscale(self, grads):
        return tree_map(lambda g: g / self._scale, grads)

    def update_scale(self, overflow: bool) -> None:
        pass

    def has_overflow(self, grads) -> bool:
        return False


class DynamicLossScaler(LossScaler):
    """/ ``scale_factor`` on an overflow (at least 1.0), x ``scale_factor``
    after ``scale_window`` clean steps."""

    def __init__(self, init_scale: float = 2.0 ** 16,
                 scale_factor: float = 2.0, scale_window: int = 2000):
        super().__init__(init_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, grads) -> bool:
        return not bool(all_finite(grads))

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            self._scale = max(self._scale / self.scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self.scale_window:
                self._scale *= self.scale_factor
                self._unskipped = 0

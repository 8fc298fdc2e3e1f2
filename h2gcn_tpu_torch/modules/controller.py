"""Training controllers: sliding-mean early stopping.

Stops when the validation loss exceeds the mean of the last ``length``
epochs; incremental O(1) mean update. Reference:
h2gcn/modules/controller.py:4-30 (``length=0`` disables). A copy of
``h2gcn_tpu.modules.controller``.
"""

from collections import deque

from .. import tracing


class PatienceEarlyStopping:
    """Stop when a maximized metric has not improved for ``patience`` epochs.

    The MixHop reference's AccuracyMonitor semantics
    (baselines/mixhop/mixhop_trainer.py:134-168): tracks the best validation
    accuracy and halts after ``patience`` stagnant steps. ``patience=0``
    disables. Call with the CURRENT metric value; returns True to stop.
    """

    def __init__(self, patience: int, mode: str = "max"):
        self.patience = patience
        self.mode = mode
        self.best = None
        self.best_step = 0
        self.step = 0

    def reset(self):
        self.best = None
        self.best_step = 0
        self.step = 0

    def __call__(self, value) -> bool:
        value = tracing.readback(value)
        if self.mode == "min":
            value = -value
        self.step += 1
        if self.best is None or value > self.best:
            self.best = value
            self.best_step = self.step
            return False
        if self.patience > 0 and self.step > self.best_step + self.patience:
            return True
        return False


class SlidingMeanEarlyStopping:
    def __init__(self, length: int):
        self.epoch_history = deque(maxlen=length)
        self._mean_value = 0.0

    @property
    def length(self):
        return self.epoch_history.maxlen

    def reset(self):
        self.epoch_history.clear()
        self._mean_value = 0.0

    def __call__(self, value) -> bool:
        value = tracing.readback(value)
        if self.length > 0:
            if len(self.epoch_history) == self.length and value > self._mean_value:
                return True
            if len(self.epoch_history) == self.length:
                self._mean_value -= self.epoch_history.popleft() / self.length
            self.epoch_history.append(value)
            self._mean_value += value / self.length
            return False
        return False

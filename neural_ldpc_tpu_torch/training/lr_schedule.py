"""Step-decay learning-rate schedule.

Port of ``neural_ldpc_tpu/training/lr_schedule.py``: the rate decays by
``decay_rate`` once every ``decay_steps`` calls (one call per epoch), and the
decaying call still returns the pre-decay value.  In closed form over a call
counter, ``value_at(k) = initial_lr * decay_rate**(k // decay_steps)``, so a
resumed run fast-forwards by assigning the counter, and ``clone()`` hands
each ``Trainer.train`` call a fresh schedule.
"""

from __future__ import annotations


class LearningRate:
    def __init__(self, initial_lr: float, decay_rate: float = 0.0, decay_steps: int = 0):
        self.initial_lr = initial_lr
        self.decay_rate = decay_rate
        self.decay_steps = decay_steps
        self.step = 0

    def value_at(self, step: int) -> float:
        if self.decay_rate == 0 or self.decay_steps <= 0:
            return self.initial_lr
        return self.initial_lr * self.decay_rate ** (step // self.decay_steps)

    @property
    def lr(self) -> float:
        """The value the next __call__ will return."""
        return self.value_at(self.step)

    def __call__(self) -> float:
        value = self.value_at(self.step)
        self.step += 1
        return value

    def clone(self) -> "LearningRate":
        """A pristine copy (step 0) with the same decay configuration."""
        return LearningRate(self.initial_lr, self.decay_rate, self.decay_steps)

"""Keras-style ReduceLROnPlateau (counterpart of cspn_tpu/train/lr_schedule.py;
reference lr_scheduler.py).

Stateful host-side controller; the produced LR is set in the optimizer's
param_groups each epoch.  Not torch.optim.lr_scheduler.ReduceLROnPlateau,
whose patience and threshold semantics differ.  Logic matches the
reference step function (lr_scheduler.py:80-105) including its quirks:
`wait` increments *after* the
patience check, cooldown resets `wait`, and the LR floor uses
min_lr + min_lr*1e-4 as the comparison epsilon (:75,:97).

Defaults follow the reference (:40-41): factor 0.1, patience 3, cooldown 0,
min_lr 1e-6, epsilon 1e-4, mode 'min' (train.py:177 steps on val MAE).
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(
        self,
        lr: float,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 3,
        epsilon: float = 1e-4,
        cooldown: int = 0,
        min_lr: float = 1e-6,
    ):
        if factor >= 1.0:
            raise ValueError("factor must be < 1.0")
        if mode not in ("min", "max"):
            raise ValueError(f"unknown mode {mode!r}")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.cooldown_counter = 0
        self.wait = 0
        self.best = float("inf") if mode == "min" else float("-inf")
        self.lr_epsilon = min_lr * 1e-4

    def _improved(self, current: float) -> bool:
        if self.mode == "min":
            return current < self.best - self.epsilon
        return current > self.best + self.epsilon

    def in_cooldown(self) -> bool:
        return self.cooldown_counter > 0

    def step(self, metric: float) -> float:
        """Update with this epoch's monitored metric; returns current LR."""
        if self.in_cooldown():
            self.cooldown_counter -= 1
            self.wait = 0
        if self._improved(metric):
            self.best = metric
            self.wait = 0
        elif not self.in_cooldown():
            if self.wait >= self.patience:
                if self.lr > self.min_lr + self.lr_epsilon:
                    self.lr = max(self.lr * self.factor, self.min_lr)
                    self.cooldown_counter = self.cooldown
                    self.wait = 0
            self.wait += 1
        return self.lr

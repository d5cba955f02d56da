"""Checkpointing (counterpart of cspn_tpu/train/checkpoint.py; reference:
torch.save per epoch + best_model.pth, train.py:229-231,277-280).

As in the JAX package, the FULL train state is saved -- the model's state
dict (parameters and BN statistics), the optimizer's state, the step, the
epoch, the best RMSE and the LR -- so a resume continues exactly.  Each
checkpoint is one `torch.save` file, `<save_dir>/epoch_NN.pt` or
`<save_dir>/best_model.pt`, written to a temporary name and renamed, so a
reader never sees half a file.  `train/evaluate.py:load_eval_state` reads
the model entry of a best_model.pt.
"""

from __future__ import annotations

import os
import re

import torch

from cspn_tpu_torch.train.state import TrainState

_EPOCH = re.compile(r"epoch_(\d+)\.pt")


class CheckpointManager:
    def __init__(self, save_dir: str, max_to_keep: int = 3):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, name: str) -> str:
        return os.path.join(self.save_dir, f"{name}.pt")

    def _save(self, tree: dict, name: str):
        tmp = self.path(name) + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self.path(name))

    def save_epoch(self, tree: dict, epoch: int):
        self._save(tree, f"epoch_{epoch:02d}")
        self._gc()

    def save_best(self, tree: dict):
        self._save(tree, "best_model")

    def restore(self, name: str, map_location=None) -> dict:
        """The tree saved as `name` ('best_model' or 'epoch_NN')."""
        return torch.load(self.path(name), map_location=map_location, weights_only=True)

    def has(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def _epochs(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.save_dir)
                      if (m := _EPOCH.fullmatch(f)))

    def latest_epoch(self) -> int | None:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def _gc(self):
        for e in self._epochs()[: -self.max_to_keep]:
            os.unlink(self.path(f"epoch_{e:02d}"))


def state_to_tree(state: TrainState, epoch: int, best_rmse: float, lr: float) -> dict:
    """The train state and the host-side training metadata as one dict."""
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "best_rmse": float(best_rmse),
        "lr": float(lr),
    }

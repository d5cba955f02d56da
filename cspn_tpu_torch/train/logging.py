"""Console and TSV logging (counterpart of cspn_tpu/train/logging.py;
reference utils.py:61-172).

The files are column-compatible with the reference's
log_train.txt/log_eval.txt (utils.py:138-172): tab-separated epoch, lr,
bestModel flag, then the metric columns in reference order.
"""

from __future__ import annotations

import os

_LOG_COLUMNS = (
    "MSE",
    "RMSE",
    "MAE",
    "DELTA1.02",
    "DELTA1.05",
    "DELTA1.10",
    "DELTA1.25",
    "DELTA1.25^2",
    "DELTA1.25^3",
    "ABS_REL",
)

_HEADER = (
    "epoch\t lr\t bestModel\t MSE\t RMSE\t MAE\t "
    "DELTA1.02\t DELTA1.05\t DELTA1.10\t DELTA1.25\t "
    "DELTA1.25^2\t DELTA1.25^3\t ABS_REL\n"
)


class TsvLogger:
    """Writes log_train.txt / log_eval.txt in the reference format."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        for name in ("log_train.txt", "log_eval.txt"):
            with open(os.path.join(save_dir, name), "w") as f:
                f.write(_HEADER)

    def log(self, split: str, epoch: int, lr: float, best_model: bool, error_avg: dict):
        name = "log_train.txt" if split == "train" else "log_eval.txt"
        vals = [float(epoch), float(lr), float(best_model)] + [
            float(error_avg[k]) for k in _LOG_COLUMNS
        ]
        line = "%.4f\t %.4f\t %.4f\t\t " % tuple(vals[:3])
        line += "\t ".join("%.4f" % v for v in vals[3:]) + "\n"
        with open(os.path.join(self.save_dir, name), "a") as f:
            f.write(line)


def format_error(split: str, epoch: int, step: int, loss: float, error: dict,
                 error_avg: dict | None = None) -> str:
    """Console report (reference print_error/print_single_error, utils.py:61-90)."""

    def fmt(k):
        if error_avg is not None:
            return f"{k}={error[k]:.4f}({error_avg[k]:.4f})"
        return f"{k}={error[k]:.4f}"

    lines = [
        f"{split} ===> Epoch: {epoch}, step: {step}, loss={loss:.4f}",
        "  " + "\t".join(fmt(k) for k in ("MSE", "RMSE", "MAE", "ABS_REL")),
        "  " + "\t".join(fmt(k) for k in ("DELTA1.02", "DELTA1.05", "DELTA1.10")),
        "  " + "\t".join(fmt(k) for k in ("DELTA1.25", "DELTA1.25^2", "DELTA1.25^3")),
    ]
    return "\n".join(lines)

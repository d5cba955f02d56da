"""Console report (counterpart of cspn_tpu/train/logging.py:format_error;
reference print_error/print_single_error, utils.py:61-90)."""

from __future__ import annotations


def format_error(split: str, epoch: int, step: int, loss: float, error: dict,
                 error_avg: dict | None = None) -> str:
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

"""Training and evaluation metrics."""

from sciml_pde_torch.metrics.metrics import (
    fft_lp_loss,
    fft_mse_loss,
    inverse_metrics,
    lp_loss,
    metric_func,
    nrmse_loss,
)

__all__ = [
    "metric_func",
    "nrmse_loss",
    "lp_loss",
    "fft_lp_loss",
    "fft_mse_loss",
    "inverse_metrics",
]

"""Training and evaluation metrics."""

from sciml_pde_torch.metrics.metrics import nrmse_loss

__all__ = ["nrmse_loss"]

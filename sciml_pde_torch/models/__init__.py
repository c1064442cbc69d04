"""Neural operator models."""

from sciml_pde_torch.models.fno import FNO2d, FNO2dAux, FNO3d, FNO3dAux

__all__ = ["FNO2d", "FNO2dAux", "FNO3d", "FNO3dAux"]

"""Rollout evaluation and result aggregation."""

from sciml_pde_torch.eval.rollout import evaluate_rollout, rollout_predict

__all__ = ["rollout_predict", "evaluate_rollout"]

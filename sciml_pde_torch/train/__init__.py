"""Training: the fused FNO-2D baseline step, the trainer and its CLI."""

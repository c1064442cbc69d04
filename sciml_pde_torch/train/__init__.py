"""Training: the FNO-2D steps (fused and production baseline, aux joint
training), the trainers with their evaluation branch, and the CLI."""

"""Training: the FNO steps (fused and production baseline in 2D, the
production step in 3D, aux joint training), the trainers with their
evaluation branch, and the CLI."""

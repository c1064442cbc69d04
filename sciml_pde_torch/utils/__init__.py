"""Utilities: weight conversion, checkpoints, configs."""

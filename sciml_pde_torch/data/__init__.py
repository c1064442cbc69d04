"""Trajectory stores on the device and window batching."""

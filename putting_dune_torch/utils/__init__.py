"""Checkpoints, the train CLI, the shared epoch loop and profiling helpers."""

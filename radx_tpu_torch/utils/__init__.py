"""Utilities: CUDA-event timing (timing.py)."""

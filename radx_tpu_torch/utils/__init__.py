"""Utilities: CUDA-event timing (timing.py); the watchdog and deterministic
retry around device steps (guard.py)."""

"""Configs, logs, progress, memory budget, checkpoints."""

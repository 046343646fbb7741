"""Fault tolerance: step-atomic, asynchronous checkpoints."""

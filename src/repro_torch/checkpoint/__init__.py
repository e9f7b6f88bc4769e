"""Atomic, keep-K, optionally asynchronous checkpoints of the train
state."""

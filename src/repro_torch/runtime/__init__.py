"""Fault tolerance of the train path: injected faults, stragglers and a
step timer; elastic rescaling onto another mesh."""

"""repro_torch.core — trace container, the shared energy integrator, the
three estimators and their batched dispatch, in PyTorch."""

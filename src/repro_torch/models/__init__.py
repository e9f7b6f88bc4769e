"""repro_torch.models — the dense GQA decoder of the LM harness, in
PyTorch: configuration, parameter metadata, layers and the model."""

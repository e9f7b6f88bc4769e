"""repro_torch.launch — entry points (LM serving)."""

"""repro_torch.analysis — the JEDEC protocol linter over command traces."""

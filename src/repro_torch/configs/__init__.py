"""repro_torch.configs — the published model configurations the port
runs (copies of ``repro.configs``' dense GQA decoders) and their
registry."""

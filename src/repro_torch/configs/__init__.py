"""repro_torch.configs — the published model configurations the port
runs (copies of ``repro.configs``' GQA and MLA decoders, dense and MoE)
and their registry."""

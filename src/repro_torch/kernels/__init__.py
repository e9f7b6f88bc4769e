"""repro_torch.kernels — hand-written Hopper kernels (CUDA C++ under
``repro_torch/csrc``), their wrappers, plain PyTorch versions and
assemblers."""

"""repro_torch — the PyTorch/CUDA port of the VAMPIRE DRAM-power system.

It mirrors ``repro``'s layout and names module for module, runs on an
NVIDIA H100 (hand-written CUDA kernels under ``csrc/``, built at first use
by ``kernels/build.py``) and on the CPU when the caller asks for it.  It
imports neither JAX nor ``repro``: the fitted model comes across as a
schema-v2 ``.npz`` file (``core.model_api.load_estimator``)."""

"""Hand-written CUDA kernels for Hopper (sources in `dldkd_tpu_torch/csrc/`),
each beside its plain PyTorch version and its launch counter. Importing
these modules builds nothing: `build.py` compiles at first launch."""

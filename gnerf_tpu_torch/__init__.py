"""gnerf_tpu_torch: the PyTorch / CUDA (H100) port of gnerf_tpu.

Mirrors the JAX package's layout (`ops/`, `render/`, `models/`, `utils/`,
`infer/`) and names, reads its npz checkpoints, and never imports JAX or
`gnerf_tpu`. Hand-written CUDA kernels live in `csrc/` and are built with
`nvcc` at first use (`ops/cuda_build.py`). Entry points run on CUDA unless
the caller passes `device="cpu"`.
"""

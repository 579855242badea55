"""PyTorch/CUDA port of ollamamq_tpu: the single-device serving path of
llama-family models, with hand-written CUDA kernels for Hopper (sm_90a)
in csrc/. Imports torch and numpy; never JAX or ollamamq_tpu."""

__version__ = "0.1.0"

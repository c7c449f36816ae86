"""PyTorch + CUDA port of lart_tpu for NVIDIA Hopper GPUs.

The package mirrors lart_tpu's layout.  It imports torch and never jax: it
reads the namelist with lart_tpu.config and writes the LaRT-schema output
through lart_tpu.io.iofile, both of which are jax-free.  Every device
kernel of the supported path is a hand-written CUDA kernel (csrc/), with a
plain PyTorch version beside it that the CPU runs.
"""

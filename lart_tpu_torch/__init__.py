"""PyTorch + CUDA port of lart_tpu for NVIDIA Hopper GPUs.

The package mirrors lart_tpu's layout.  It imports torch and never jax or
anything of lart_tpu: it reads the namelist with its own copy of
lart_tpu's config module and writes the LaRT-schema output through its own
io/iofile.py, so lart_tpu's readers read its files.  Every device kernel
of the supported path is a hand-written CUDA kernel (csrc/), with a plain
PyTorch version beside it that the CPU runs.
"""

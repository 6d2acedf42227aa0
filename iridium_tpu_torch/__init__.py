"""iridium-tpu on PyTorch and CUDA: the offline Iridium burst decode
(capture file -> detect -> route -> front-end -> downmix -> demod -> RAW
lines) on an NVIDIA GPU, with the JAX package's Pallas kernels rewritten
as hand-written CUDA kernels (`csrc/`). Entry points run on the current
CUDA device unless the caller passes `device="cpu"`.
"""

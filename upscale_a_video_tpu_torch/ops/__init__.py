"""Primitive ops and the five hand-written kernels of the main path.

Each kernel module holds a plain PyTorch version beside its wrapper; the
wrapper takes the plain version for a CPU tensor and launches the CUDA
kernel (or raises) for a CUDA tensor. ``_cuda`` builds and binds them.
"""

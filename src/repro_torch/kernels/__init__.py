# Hand-written Hopper kernels for the paper's compute hot-spot:
# Multi-Segment Attention.  Each kernel's wrapper sits beside its plain
# PyTorch version (ref.py), which the CPU tests hold against the JAX
# package and chip_smoke.py holds the kernel against on the card.

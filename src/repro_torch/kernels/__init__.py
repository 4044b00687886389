"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

    ops          public entry points (CPU → plain version, CUDA → kernel)
    ref          plain PyTorch versions
    embedding_bag  the embedding-bag kernel's wrapper and launch count
    _build       nvcc build of ``csrc/*.cu`` and ctypes loading
"""

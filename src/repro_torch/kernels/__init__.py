"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

    ops          public entry points (CPU → plain version, CUDA → kernel)
    ref          plain PyTorch versions
    embedding_bag, flash_attention, decode_attention, ssd_scan, fcfs_scan
                 each kernel's wrapper, input checks and launch count
    _build       nvcc build of ``csrc/*.cu`` and ctypes loading
"""

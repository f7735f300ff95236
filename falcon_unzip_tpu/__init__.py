"""falcon-unzip-tpu: diploid unzip + polish framework on JAX.

Phases and polishes a FALCON-style draft assembly (the FALCON_unzip
capabilities) with the alignment, phasing and consensus kernels on an
accelerator: an NVIDIA GPU, with the CPU as the test platform.
"""
__version__ = "0.1.0"

"""Compute-kernel dispatch.

Counterpart of torcheasyrec_tpu/ops/__init__.py, with the same names in
the proto's int order (TRITON=0, PYTORCH=1, CUTLASS=2, JAX=3, PALLAS=4),
so configs written for either package parse the same. Here PALLAS (the
STU default), CUTLASS and TRITON select the hand-written CUDA kernel;
PYTORCH and JAX select the plain PyTorch version. The plain version is
then an explicit request of the config, never a fallback.
"""

import enum


class Kernel(enum.Enum):
    TRITON = "TRITON"
    PYTORCH = "PYTORCH"
    CUTLASS = "CUTLASS"
    JAX = "JAX"
    PALLAS = "PALLAS"


def normalize_kernel(kernel) -> "Kernel":
    """Kernel, proto enum int or name -> Kernel."""
    if isinstance(kernel, Kernel):
        return kernel
    if isinstance(kernel, int):
        return list(Kernel)[kernel]
    return Kernel[str(kernel).upper()]


def uses_cuda_kernel(kernel) -> bool:
    """True when ``kernel`` selects the hand-written CUDA kernel."""
    return normalize_kernel(kernel) in (
        Kernel.PALLAS, Kernel.CUTLASS, Kernel.TRITON
    )

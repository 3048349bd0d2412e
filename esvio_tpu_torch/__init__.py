"""esvio_tpu_torch — the PyTorch/CUDA port of esvio_tpu.

Module for module it mirrors `esvio_tpu` (core/ events/ frontend/ imu/
solver/ init/ vio/ loop/ io/ apps/ utils/), with the same public
function names and the same array layouts at the public functions, so
that every port module sits opposite the JAX module it answers to.  The
port imports `torch` and never `jax`; the two Pallas kernels of the JAX
package are hand-written CUDA C++ for Hopper (csrc/), built with nvcc at
first use.

Importing this package loads nothing heavy: subpackages are imported where
they are used.
"""

__version__ = "0.1.0"


def disable_tf32():
    """Keep float32 matmuls and convolutions in full float32 on the card.

    The JAX reference runs its solver products at Precision.HIGHEST; a
    cuDNN convolution would otherwise run in TF32 by default."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

"""s3grl_tpu_torch: the PyTorch and CUDA port of ``s3grl_tpu``.

S3GRL link prediction (enclosing-subgraph extraction, PoS, SoP and hybrid
diffusion operators, the SIGNNet scorer) on an NVIDIA GPU. The PoS operator
kernels (``csrc/pos_power_rows.cu``) and the sparse SpMM of the SoP chain
(``csrc/bsr_spmm.cu``) are written by hand in CUDA C++ and built at
first use; everything else is plain torch. The package imports neither JAX nor
``s3grl_tpu``: the JAX package is the reference the tests hold it to.
"""

__version__ = "0.1.0"

from s3grl_tpu_torch.config import RunConfig

__all__ = ["RunConfig", "__version__"]

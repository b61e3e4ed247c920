"""Hand-written CUDA kernels of the port, each beside its plain torch version.

Importing this package builds nothing: a kernel is compiled (``_build``) the
first time a CUDA tensor reaches its wrapper.
"""

from .lnlike_kernels import (MODEL_LNLIKE, model_lnlike_batched,
                             model_lnlike_reference)
from .model_tensor import MODEL_TENSOR, ModelTensorStats, model_tensor_lnlike

__all__ = ["MODEL_LNLIKE", "MODEL_TENSOR", "ModelTensorStats",
           "model_lnlike_batched", "model_lnlike_reference",
           "model_tensor_lnlike"]

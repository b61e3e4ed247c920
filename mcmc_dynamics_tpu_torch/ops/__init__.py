"""Hand-written CUDA kernels of the port, each beside its plain torch version,
and the plain-torch ConstantFit sufficient-statistics tier.

Importing this package builds nothing: a kernel is compiled (``_build``) the
first time a CUDA tensor reaches its wrapper.  :func:`use_kernel` (``dispatch``)
decides, as a model tier is built, whether it binds the kernel or the plain
version.
"""

from .dispatch import use_kernel
from .background_kernel import (BACKGROUND_LSE, background_logsumexp,
                                background_logsumexp_reference)
from .jam_grid_kernel import JAM_GRID_RECONSTRUCT, jam_grid_reconstruct
from .jam_kernel import JAM_MOMENTS, jam_moments
from .lnlike_kernels import (CONSTANT_GB, CONSTANT_MIXTURE, DOUBLE_MODEL,
                             DOUBLE_MODEL_GB, MODEL_FREECENTER, MODEL_LNLIKE,
                             MODEL_MIXTURE, constant_gb_lnlike_batched,
                             constant_gb_lnlike_reference,
                             constant_mixture_lnlike_batched,
                             constant_mixture_lnlike_reference,
                             double_model_gb_lnlike_batched,
                             double_model_gb_lnlike_reference,
                             double_model_lnlike_batched,
                             double_model_lnlike_reference,
                             model_freecenter_lnlike_batched,
                             model_freecenter_lnlike_reference,
                             model_lnlike_batched, model_lnlike_reference,
                             model_mixture_lnlike_batched,
                             model_mixture_lnlike_reference, star_chunks)
from .model_sufficient import (MODEL_SUFFICIENT, MODEL_SUFFICIENT_MMA,
                               ModelSufficientStats, model_sufficient_lnlike,
                               model_sufficient_lnlike_mma)
from .model_tensor import MODEL_TENSOR, ModelTensorStats, model_tensor_lnlike
from .probe_mixture import (CONSTANT_GB_V2, MODEL_GB_V2,
                            constant_gb_v2_lnlike_batched,
                            constant_gb_v2_lnlike_reference,
                            model_gb_v2_lnlike_batched, model_gb_v2_lnlike_reference)
from .sufficient import ConstantSufficientStats

# every kernel's launch counter, in the order of the repository's TPU kernels,
# then the port's own (the JAM engine and the JAM grid's star reconstruction,
# which replace no TPU kernel)
KERNELS = {"model_lnlike": MODEL_LNLIKE, "model_tensor": MODEL_TENSOR,
           "model_freecenter": MODEL_FREECENTER,
           "constant_mixture": CONSTANT_MIXTURE, "constant_gb": CONSTANT_GB,
           "model_mixture": MODEL_MIXTURE, "double_model": DOUBLE_MODEL,
           "double_model_gb": DOUBLE_MODEL_GB,
           "model_sufficient": MODEL_SUFFICIENT,
           "background_lse": BACKGROUND_LSE,
           "model_sufficient_mma": MODEL_SUFFICIENT_MMA,
           "constant_gb_v2": CONSTANT_GB_V2, "model_gb_v2": MODEL_GB_V2,
           "jam_moments": JAM_MOMENTS,
           "jam_grid_reconstruct": JAM_GRID_RECONSTRUCT}

__all__ = ["MODEL_LNLIKE", "MODEL_TENSOR", "MODEL_FREECENTER", "CONSTANT_MIXTURE",
           "CONSTANT_GB", "MODEL_MIXTURE", "DOUBLE_MODEL", "DOUBLE_MODEL_GB",
           "MODEL_SUFFICIENT", "BACKGROUND_LSE", "MODEL_SUFFICIENT_MMA",
           "CONSTANT_GB_V2", "MODEL_GB_V2", "JAM_MOMENTS", "JAM_GRID_RECONSTRUCT", "KERNELS",
           "star_chunks",
           "ModelTensorStats",
           "ModelSufficientStats", "ConstantSufficientStats",
           "model_lnlike_batched", "model_lnlike_reference",
           "model_freecenter_lnlike_batched", "model_freecenter_lnlike_reference",
           "constant_mixture_lnlike_batched", "constant_mixture_lnlike_reference",
           "constant_gb_lnlike_batched", "constant_gb_lnlike_reference",
           "model_mixture_lnlike_batched", "model_mixture_lnlike_reference",
           "double_model_lnlike_batched", "double_model_lnlike_reference",
           "double_model_gb_lnlike_batched", "double_model_gb_lnlike_reference",
           "background_logsumexp", "background_logsumexp_reference",
           "model_tensor_lnlike", "model_sufficient_lnlike",
           "model_sufficient_lnlike_mma",
           "constant_gb_v2_lnlike_batched", "constant_gb_v2_lnlike_reference",
           "model_gb_v2_lnlike_batched", "model_gb_v2_lnlike_reference", "jam_moments",
           "jam_grid_reconstruct", "use_kernel"]

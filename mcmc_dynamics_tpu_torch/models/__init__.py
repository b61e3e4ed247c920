from .base import Runner, SamplerResult
from .constant import ConstantFit, ConstantFitGB
from .double_model import DoubleModelFit, DoubleModelFitGB
from .model import ModelFit, ModelFitConstantBackground, ModelFitGB
from .jam import AnalyticalProfiles, Axisymmetric, ChemoProfiles

__all__ = ["Runner", "SamplerResult", "ModelFit", "ModelFitGB",
           "ModelFitConstantBackground", "DoubleModelFit", "DoubleModelFitGB",
           "ConstantFit", "ConstantFitGB", "Axisymmetric", "AnalyticalProfiles",
           "ChemoProfiles"]

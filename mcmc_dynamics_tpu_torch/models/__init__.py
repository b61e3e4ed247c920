from .base import Runner, SamplerResult
from .constant import ConstantFit, ConstantFitGB
from .model import ModelFit

__all__ = ["Runner", "SamplerResult", "ModelFit", "ConstantFit", "ConstantFitGB"]

from .base import Runner, SamplerResult
from .model import ModelFit

__all__ = ["Runner", "SamplerResult", "ModelFit"]

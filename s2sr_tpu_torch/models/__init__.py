from .registry import MODELS, get_model_config
from .rrdbnet import RRDBNet, rrdbnet_apply

__all__ = ["MODELS", "get_model_config", "RRDBNet", "rrdbnet_apply"]

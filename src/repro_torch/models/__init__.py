from . import decoder
from .config import ModelConfig

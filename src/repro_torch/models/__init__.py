from .config import INPUT_SHAPES, InputShape, ModelConfig
from .registry import ALIASES, ARCH_IDS, build_model, get_config, get_model

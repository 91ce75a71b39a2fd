"""Config registry: the assigned LM architectures and input shapes."""
from repro_torch.configs.lm_archs import ARCHS, get_arch, smoke_config
from repro_torch.configs.shapes import SHAPES, make_batch

__all__ = ["ARCHS", "get_arch", "smoke_config", "SHAPES", "make_batch"]

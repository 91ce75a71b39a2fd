"""Config registry: the assigned LM architectures and input shapes."""
from repro_torch.configs.lm_archs import ARCHS, get_arch, smoke_config
from repro_torch.configs.shapes import SHAPES, input_specs, make_batch, \
    shape_applicable

__all__ = ["ARCHS", "get_arch", "smoke_config", "SHAPES", "input_specs",
           "make_batch", "shape_applicable"]

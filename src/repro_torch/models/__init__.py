"""Model substrate (functional torch), ported slice by slice: the layers,
the weight carrier, the dense decoder family (attention, transformer
blocks, the model) and the recurrent mixers (ssm)."""
from . import attention, convert, layers, model, ssm, transformer
from .convert import params_from_numpy
from .model import Model, count_params, model_flops_per_token

__all__ = ["attention", "convert", "layers", "model", "ssm", "transformer",
           "params_from_numpy", "Model", "count_params",
           "model_flops_per_token"]

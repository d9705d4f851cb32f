"""Model substrate (functional torch), ported slice by slice: the layers,
the weight carrier, the decoder stack (attention with MLA, transformer
blocks, the model), the MoE FFN (moe) and the recurrent mixers (ssm)."""
from . import attention, convert, layers, model, moe, ssm, transformer
from .convert import params_from_numpy
from .model import Model, count_params, model_flops_per_token

__all__ = ["attention", "convert", "layers", "model", "moe", "ssm",
           "transformer", "params_from_numpy", "Model", "count_params",
           "model_flops_per_token"]

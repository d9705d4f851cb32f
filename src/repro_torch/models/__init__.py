"""Model substrate (functional torch), ported slice by slice: the layers
and the weight carrier so far; attention, transformer and model follow."""
from . import convert, layers
from .convert import params_from_numpy

__all__ = ["convert", "layers", "params_from_numpy"]

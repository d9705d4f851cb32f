"""Distribution: the LM's sharding rules, compressed collectives and
pipeline parallelism (``sharding``, ``collectives``, ``pipeline``), and
the sharding glue of the sharded FFT (``fft_sharding``)."""
from .sharding import (dp_axes, param_specs, batch_specs, cache_specs,
                       shard_tree_specs, logical_rules, current_mesh,
                       use_mesh, shard_tree, gather_tree)
from .collectives import (compress_allreduce_mean, quantize_int8,
                          dequantize_int8)
from .pipeline import pipeline_apply
from .fft_sharding import (abft_group_layout, abft_group_spec,
                           chunk_layout, data_mesh_axis, fft_mesh_axis,
                           half_spectrum_shape, infer_fft_mesh, layout_specs,
                           pencil_nd_specs, pencil_specs, placements,
                           shard_grid, shard_signals, signal_specs,
                           slab_specs)

__all__ = ["dp_axes", "param_specs", "batch_specs", "cache_specs",
           "shard_tree_specs", "logical_rules", "current_mesh", "use_mesh",
           "shard_tree", "gather_tree", "compress_allreduce_mean",
           "quantize_int8", "dequantize_int8", "pipeline_apply",
           "fft_mesh_axis", "infer_fft_mesh", "pencil_specs",
           "shard_signals", "data_mesh_axis", "abft_group_layout",
           "abft_group_spec", "chunk_layout", "slab_specs",
           "pencil_nd_specs", "shard_grid", "layout_specs",
           "half_spectrum_shape", "placements", "signal_specs"]

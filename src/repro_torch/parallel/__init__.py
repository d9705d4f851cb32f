"""Distribution: the sharding glue of the sharded FFT (``fft_sharding``).

The LM parallelism of the reference's ``repro.parallel`` (``sharding``,
``collectives``, ``pipeline``) is ROADMAP queue 1 item 12.
"""
from .fft_sharding import (abft_group_layout, abft_group_spec,
                           chunk_layout, data_mesh_axis, fft_mesh_axis,
                           half_spectrum_shape, infer_fft_mesh, layout_specs,
                           pencil_nd_specs, pencil_specs, placements,
                           shard_grid, shard_signals, signal_specs,
                           slab_specs)

__all__ = ["fft_mesh_axis", "infer_fft_mesh", "pencil_specs",
           "shard_signals", "data_mesh_axis", "abft_group_layout",
           "abft_group_spec", "chunk_layout", "slab_specs",
           "pencil_nd_specs", "shard_grid", "layout_specs",
           "half_spectrum_shape", "placements", "signal_specs"]

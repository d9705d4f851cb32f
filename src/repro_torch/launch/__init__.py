"""Command-line entry points of the port: ``python -m
repro_torch.launch.serve`` (the FFT endpoint and the serving runtime);
``launch.mesh`` builds the device meshes (the sharded FFT's and the LM's),
``launch.elastic`` restores a checkpoint onto a new mesh."""

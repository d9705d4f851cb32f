"""Command-line entry points of the port: ``python -m
repro_torch.launch.serve`` (the FFT endpoint and the serving runtime);
``launch.mesh.make_fft_mesh`` builds the sharded FFT's device mesh."""

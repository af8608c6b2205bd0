# Command-line entry points (``python -m repro_torch.launch.serve``).

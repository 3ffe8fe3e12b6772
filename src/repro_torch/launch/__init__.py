"""Command-line entry points of the port: `python -m repro_torch.launch.serve`
drives a `SessionServer` under a bursty arrival mix."""

"""Command-line entry points of the port: `python -m repro_torch.launch.serve`
drives a `SessionServer` under a bursty arrival mix, `python -m
repro_torch.launch.fleet` a sharded co-design sweep over devices and
processes (`launch.mesh` describes their mesh), `python -m
repro_torch.launch.train` trains a model (`launch.specs` gives the
abstract inputs and specs of every arch x shape cell)."""

"""The ReSiPI model of the port. Level 1 (the paper's network): constants,
topology, selection, photonics, noc, gateway_controller, traffic and
simulator. Level 2: reconfig_runtime, the same controller driving the
communication lanes of a multi-GPU runtime. Fleet: distributed."""
from repro_torch.core import reconfig_runtime

__all__ = ["reconfig_runtime"]

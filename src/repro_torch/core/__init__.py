"""The ReSiPI Level-1 network model of the port: constants, topology,
selection, photonics, noc, gateway_controller, traffic and simulator."""

"""The serving layer of the port (`repro.serve` counterpart): `policies`
(the `ServerPolicy` knobs and the signal / reason taxonomy), `scheduler`
(requests, per-session state, the admission queue), `resilience` (the
degradation detector, `plan_replacement` through the device placement
search, `ResilienceRuntime`) and `engine` (`SessionServer`, packing
resident sessions into one `session_tick` per dispatch, and
`replay_standalone`)."""

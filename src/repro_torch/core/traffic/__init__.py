"""Traffic subsystem of the port (`repro.core.traffic` counterpart).

  * `specs` — the frozen `TrafficSpec` hierarchy (PARSEC profiles and the
    synthetic NoC workloads), a verbatim copy;
  * `dest` — row-stochastic destination matrices per spec;
  * `generators` — `generate(spec, key, cfg)` with a threefry-twin key
    (the reference's trace for the same key);
  * `transform` — validation, slicing, padding, chunking, concatenation.
"""
from repro_torch.core.traffic.specs import (ALL_SYNTHETIC_SPECS, APP_NAMES,
                                            AppProfile, BurstySpec,
                                            HotspotSpec, PARSEC,
                                            PERMUTATION_PATTERNS, ParsecSpec,
                                            PermutationSpec, TrafficSpec,
                                            UniformSpec, as_spec,
                                            expected_mean_ext_load,
                                            permutation_destinations)
from repro_torch.core.traffic.dest import (destination_matrix,
                                           destination_matrix_torch)
from repro_torch.core.traffic.generators import (all_app_traces, generate,
                                                 generate_trace)
from repro_torch.core.traffic.transform import (TRACE_KEYS, chunk_trace,
                                                concat_traces, pad_trace,
                                                slice_trace, trace_length,
                                                validate_trace)

__all__ = [
    "ALL_SYNTHETIC_SPECS", "APP_NAMES", "AppProfile", "BurstySpec",
    "HotspotSpec", "PARSEC", "PERMUTATION_PATTERNS", "ParsecSpec",
    "PermutationSpec", "TRACE_KEYS", "TrafficSpec", "UniformSpec",
    "all_app_traces", "as_spec", "chunk_trace",
    "concat_traces", "destination_matrix", "destination_matrix_torch",
    "expected_mean_ext_load", "generate", "generate_trace", "pad_trace",
    "permutation_destinations", "slice_trace", "trace_length",
    "validate_trace",
]

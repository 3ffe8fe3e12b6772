"""Process-level runtime helpers of the port: the warm-start cache of the
kernel libraries and the memoized entry points (`runtime.cache`), the
trainer's fault tolerance (`runtime.fault_tolerance`) and elastic
re-meshing (`runtime.elastic`)."""

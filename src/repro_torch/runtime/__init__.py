"""Process-level runtime helpers of the port: the warm-start cache of the
kernel libraries and the memoized entry points (`runtime.cache`)."""

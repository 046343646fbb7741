"""Training input path: the host staging cache, the push server and the
prefetching loader (the paper's push-based delivery applied to the input
pipeline)."""

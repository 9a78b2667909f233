"""Shared parts of the harness: the manifest and the files found by name,
the device checks, spans, the profiler reader, peaks, FLOP counting, the
traffic generators and the check that no JAX is loaded."""

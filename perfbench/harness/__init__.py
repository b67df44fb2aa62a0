"""The harness: manifest, inputs, the frame generator, tracing, the check
and the run of one cell."""

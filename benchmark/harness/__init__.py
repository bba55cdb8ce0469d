"""The benchmark harness: cells found by name, the generator, spans, the trace and the run loop."""

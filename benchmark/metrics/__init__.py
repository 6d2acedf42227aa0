"""Per-layer metric readers: one module a metric, named as the metric,
each with its `UNIT` and `read(ctx)`, which returns the metric's value or
None where the traced window holds nothing to read (no device trace on
the CPU, no launch of the kernel). `ctx` (harness.run_cell) holds the
parsed device trace (`trace`, or None), the pipeline's host timing deltas
over the window (`timing`), the window's blocks, detected bursts, groups
and per-line latencies (`lat_ms`), the bytes of a block, the reference's
detector parameters (`p`) and decoder constants (`dec`), and the probed
front-end launches (`frontend`)."""

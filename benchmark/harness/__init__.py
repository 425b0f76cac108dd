"""The harness shared by every cell: loading, tracing, weights, peaks."""

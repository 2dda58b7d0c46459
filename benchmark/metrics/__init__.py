"""One reader a per-layer metric, found by the part of the metric's name
before its first `.`; the part after it is the mix's kind whose runs the
metric is read in. `read(ctx, suffix)` takes a `benchmark.mixes.Reading` and
returns the value, or None when there is nothing to read."""

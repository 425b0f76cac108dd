"""Milliseconds a volume in the pipeline's decode: the benchmark's own
span around each ``decode_samples`` sub-batch in the traced window,
ended by ``synchronize()``, over the volumes decoded in them."""


def read(run):
    spans = run.spans.get("pipeline.decode", [])
    if not spans:
        return None
    return 1e3 * sum(spans) / (len(spans) * run.facts["decode_batch"])

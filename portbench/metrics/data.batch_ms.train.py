"""Host ms a training batch takes inside the program's batcher (the
harness's span around ``next()`` of the batch stream: ``Batcher.materialize``
with word dropout)."""
from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "train", "data")

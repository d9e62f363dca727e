"""Host ms a training step takes inside ``Trainer.update_chunk`` (the
harness's span around the call: staging copy, graph replay)."""
from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "train", "update")

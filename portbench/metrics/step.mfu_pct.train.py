"""The whole step's share of the published peak: the window's model FLOPs
on real tokens and edges ÷ its seconds ÷ the peak."""
from portbench.readers import mfu_pct


def read(run):
    return mfu_pct(run, "train")

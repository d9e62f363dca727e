"""Idle share of the device over the traced evaluation sub-window."""
from portbench.readers import idle_pct


def read(run):
    return idle_pct(run, "eval")

"""The scan kernels' (csrc/lstm_scan*.cu) share of their roofline over the
traced sub-window: Σ least time of each launch on its real tokens ÷ Σ
profiled time."""
from portbench import flops
from portbench.readers import roofline_pct

NAMES = ("lstm_scan_fwd_kernel", "lstm_gates_", "lstm_chain_kernel",
         "lstm_dw_kernel")


def read(run):
    return roofline_pct(run, "train", NAMES, flops.scan_launches)

"""The grouped-matmul kernels' (csrc/grouped_matmul*.cu) share of their
roofline over the traced sub-window: Σ least time of each launch on its
real tokens ÷ Σ profiled time."""
from portbench import flops
from portbench.readers import roofline_pct

NAMES = ("grouped_matmul_fwd_kernel", "grouped_matmul_dx_kernel",
         "grouped_matmul_ds_kernel", "grouped_matmul_ds_sum_kernel",
         "grouped_matmul_fwd_bf16_kernel", "grouped_matmul_dx_bf16_kernel",
         "grouped_matmul_ds_bf16_kernel",
         "grouped_matmul_ds_sum_bf16_kernel")


def read(run):
    return roofline_pct(run, "eval", NAMES, flops.grouped_matmul_launches)

"""The gradients' all-reduce's share of its roofline: the least time any
all-reduce could take, one step's gradient bytes (`_params.grad_bytes`)
arriving at a rank over its NVLink in one direction (`_peaks`), over the
device time of the communication kernels a step (`comm_device_ms`). Every
rank has to receive every reduced byte, whatever the algorithm (in-switch
reduction included), so the share cannot pass 100%."""

from ._peaks import NVLINK_BYTES_PER_S
from .comm_device_ms import read as comm_device_ms


def read(r):
    ms = comm_device_ms(r)
    if ms is None or not r.grad_bytes:
        return None
    return 100.0 * r.grad_bytes / NVLINK_BYTES_PER_S / (ms / 1e3)

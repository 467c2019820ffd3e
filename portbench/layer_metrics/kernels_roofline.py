"""ops/kernels: the sum of each kernel launch's least time on the card
(portbench/roofline.py, from the launch's shapes) over the sum of the
kernels' device time, %."""

from portbench import trace as tr


def read(trace):
    device_s = sum(trace.kernel_device_s().values())
    if device_s <= 0 or not trace.launches:
        return None
    from portbench import roofline

    least = sum(roofline.bound_s(*tr.launch_work(x))
                for x in trace.launches) * trace.launch_repeats
    return 100.0 * least / device_s

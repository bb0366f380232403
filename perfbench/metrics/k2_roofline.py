"""K2's share of its roofline, in %: the least time the searches of the
traced run's frames could take at the card's peak (``roofline/k2.py``,
bound by operations at every speed the cells run) over the device time of
K2's records. Only where the profiler kept every K2 launch."""

from perfbench.readings import K2_KERNEL, every_k2_record
from perfbench.roofline import k2


def read(run):
    if not every_k2_record(run):
        return None
    c = run.config
    bound = k2.frame_bound_s(c["width"], c["height"], c["speed"], run.device_kind)
    frames = run.frames(run.requests)
    spent = run.device.seconds(K2_KERNEL)
    if bound is None or not frames or spent <= 0:
        return None
    return 100.0 * frames * bound[0] / spent

"""The trace reduction on hand-made events: device busy as a union, device
time attributed to the span a kernel was launched in (on its thread),
idle gaps named by the innermost open span, device-side copies of the
ranges left out."""

import torch

from benchlib.trace import reduce_events

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, tid=1):
        self._v = (name, dev, start, dur, corr, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[0].startswith("bench.")


def test_reduce_events():
    events = [
        Ev("bench.song", CPU, 0, 1000),
        Ev("bench.b1", CPU, 100, 100),
        Ev("cudaLaunchKernel", CPU, 120, 5, corr=7),
        Ev("cudaLaunchKernel", CPU, 300, 5, corr=8),
        Ev("cudaLaunchKernel", CPU, 310, 5, corr=9, tid=2),   # another thread
        Ev("bench.b1", CUDA, 150, 400),                         # the range's device copy
        Ev("gemm_kernel", CUDA, 150, 100, corr=7),
        Ev("elementwise_kernel", CUDA, 200, 100, corr=8),       # overlaps the first
        Ev("other_kernel", CUDA, 600, 100, corr=9),
    ]
    s = reduce_events(events, 0, 1000)
    assert s.busy_s * 1e9 == 150 + 100          # [150, 300) and [600, 700)
    assert round(s.span_device_s["b1"] * 1e9) == 100
    assert round(s.span_device_s["song"] * 1e9) == 200
    gaps = dict(s.idle_gaps)
    # Gaps [0, 150), [300, 600) and [700, 1000), each midpoint inside song alone.
    assert list(gaps) == ["song"] and round(gaps["song"] * 1e9) == 750
    assert [n for n, _ in s.device_ops] == ["gemm_kernel", "elementwise_kernel", "other_kernel"]

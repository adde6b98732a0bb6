"""The trace reader's arithmetic on a hand-made event list: busy time as
the union of device intervals inside the harness's ranges, kernels by
name, idle gaps under the innermost host event; and the launches
metric read from it."""

from types import SimpleNamespace

import torch

from portbench import spec, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, start, dur, dev=CPU, ann=False, tid=1):
        self._v = (name, start, dur, dev, ann, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def _prof(events):
    res = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))


def test_busy_kernels_and_gaps():
    evs = [Ev("pb.fit", 0, 1000, ann=True),
           Ev("pb.fit", 0, 1000, dev=CUDA, ann=True),
           Ev("cudaGraphLaunch", 100, 500),
           Ev("aten::item", 700, 200),
           Ev("void repro::gram_kernel<double, true>(double const*)", 50,
              100, dev=CUDA),
           Ev("void repro::row_wss_rows_kernel<double, 1>(int)", 120, 80,
              dev=CUDA),
           Ev("Memcpy DtoH (Device -> Pageable)", 600, 100, dev=CUDA),
           Ev("void other(int)", 1900, 100, dev=CUDA)]
    t = trace.read(_prof(evs))
    assert t.window_s == 1000 / 1e9
    # [50, 200) and [600, 700): 250 ns busy inside [0, 1000)
    assert t.busy_s == 250 / 1e9
    assert t.kernels == {"gram_kernel": (1, 100 / 1e9),
                         "row_wss_rows_kernel": (1, 80 / 1e9),
                         "Memcpy DtoH (Device -> Pageable)": (1, 100 / 1e9)}
    # gaps [0, 50) under pb.fit alone, [200, 600) in the graph launch,
    # [700, 1000) in aten::item
    assert t.idle == {"pb.fit/python": 50 / 1e9,
                      "pb.fit/cudaGraphLaunch": 400 / 1e9,
                      "pb.fit/aten::item": 300 / 1e9}
    # two kernels in the window; the copy is not one
    assert t.kernel_launches == 2


def test_launches_per_iter_counts_every_kernel():
    read = spec.module("metrics", "kernels.launches_per_iter").read
    t = SimpleNamespace(kernel_launches=2240, loop_iterations=10)
    assert read(SimpleNamespace(trace=t)) == 224.0
    t.loop_iterations = 0
    assert read(SimpleNamespace(trace=t)) is None


def test_no_device_event_reads_nothing():
    assert trace.read(_prof([Ev("pb.fit", 0, 10, ann=True)])) is None

"""The trace's reduction on a hand-made profile: a device operation belongs
to the range in which the host launched it, found through its runtime call
or its operator, whenever the device ran it; an idle gap belongs to the
range the host was in."""

from perfbench.trace import OUTSIDE, Event, Trace


def _host(name, start, end, corr=0):
    return Event(name, False, start, end, corr, 0, name.startswith("bench."))


def _device(name, start, end, corr=0, linked=0):
    return Event(name, True, start, end, corr, linked, False)


EVENTS = [
    _host("bench.slice", 0, 10_000),
    _host("bench.encode", 1_000, 2_000),
    _host("cudaLaunchKernel", 1_500, 1_510, corr=7),
    _host("aten::mm", 1_600, 1_700, corr=7),  # an operator's id may equal a runtime call's
    _host("bench.decode", 3_000, 9_000),
    _host("cudaLaunchKernel", 3_500, 3_510, corr=8),
    _host("aten::add", 4_000, 4_100, corr=31),
    # the encoder's kernel runs while the host is already in the decode
    _device("flash_fwd_wgmma_kernel", 3_200, 3_700, corr=7),
    _device("beam_attend_append_kernel", 3_800, 4_000, corr=8),
    # no runtime call in the profile: placed by its operator
    _device("elementwise_kernel", 4_200, 4_300, corr=99, linked=31),
    # the device's span of a range, which the profiler may misplace
    Event("bench.encode", True, 3_800, 4_300, 0, 0, True),
]


def test_operations_belong_to_the_range_that_launched_them():
    tr = Trace(EVENTS)
    assert tr.by_link == 3 and tr.by_span == 0
    assert tr.device_seconds("bench.encode") == 500 / 1e9
    assert tr.device_seconds("bench.decode") == 300 / 1e9
    assert tr.device_seconds("bench.decode", names=["beam_attend"]) == 200 / 1e9
    assert tr.busy_s == 800 / 1e9 and tr.window_s == 10_000 / 1e9
    assert tr.launches_in("bench.decode") == 1 and tr.launches_in("bench.encode") == 1


def test_idle_gaps_belong_to_the_range_the_host_was_in():
    gaps = dict(Trace(EVENTS).breakdown()["idle_gaps"])
    # [0, 3200): mid 1600 in the encode; [3700, 3800), [4000, 4200),
    # [4300, 10000): mids 3750, 4100 in the decode, 7150 too
    assert set(gaps) == {"bench.encode", "bench.decode"}
    assert gaps["bench.encode"] == 3_200 / 1e9
    assert abs(gaps["bench.decode"] - 6_000 / 1e9) < 1e-15
    tr = Trace(EVENTS[:1] + [_device("k", 100, 200)])
    assert dict(tr.breakdown()["idle_gaps"]) == {OUTSIDE: 9_900 / 1e9}
    assert tr.by_span == 1 and tr.kernels[0][4] == OUTSIDE

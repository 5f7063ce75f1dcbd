"""The readers of the program's own spans and counters (``imu_device_ms``,
``images_decoded``, ``prep_cpu_ms``) on hand-built contexts, each with its
case of nothing to read, and the trace reader on the program's ``islam::``
ranges: a gap inside one takes its name, and the device side of a range is
no work."""

from types import SimpleNamespace

import pytest
import torch

import pb_helpers  # noqa: F401  (the repository's root on the path)
from portbench.harness import spec, trace


def _kernel(start, end, stack, name="k"):
    return trace.Kernel(start, end, name, tuple(stack), False)


def _trace(kernels):
    return trace.Trace(0, 100, 0, kernels, [])


def _ctx(trace_=None, splits=(), traced=3):
    return SimpleNamespace(trace=trace_, traced=traced,
                           epoch={"prep_split_seconds": list(splits)})


def _split(decode, transforms, **extra):
    return {"decode": decode, "transforms": transforms, "copy": 0.01,
            **extra}


def test_imu_device_ms_reads_the_imu_range():
    kernels = [
        _kernel(0, 2_000_000, ["islam::step", "islam::imu", "aten::mul"]),
        _kernel(3_000_000, 4_000_000, ["islam::step", "islam::imu"]),
        _kernel(5_000_000, 9_000_000, ["islam::step", "islam::pvgo"]),
        _kernel(9_000_000, 9_500_000, ["module::flowNet"])]
    got = spec.reader("imu_device_ms")(_ctx(_trace(kernels), traced=3))
    assert got == pytest.approx(3.0 / 3)


@pytest.mark.parametrize("case", ["no trace", "no range"])
def test_imu_device_ms_reads_nothing(case):
    t = None if case == "no trace" else _trace(
        [_kernel(0, 10, ["module::flowNet", "aten::conv2d"])])
    assert spec.reader("imu_device_ms")(_ctx(t)) is None


def test_host_records_read_their_counters():
    splits = [_split(0.5, 0.3, images=32, cpu=0.6),
              _split(0.4, 0.2, images=32, cpu=0.5)]
    ctx = _ctx(splits=splits)
    assert spec.reader("images_decoded")(ctx) == 32
    assert spec.reader("prep_cpu_ms")(ctx) == pytest.approx(550.0)
    # host_prep_ms keeps its boundaries: decode + transforms, by wall clock
    assert spec.reader("host_prep_ms")(ctx) == pytest.approx(700.0)


@pytest.mark.parametrize("name", ["images_decoded", "prep_cpu_ms"])
@pytest.mark.parametrize("case", ["no windows", "records without it"])
def test_host_records_read_nothing(name, case):
    """An epoch of no window, or a program whose records hold only the
    wall-clock split (decode, transforms, copy)."""
    splits = [] if case == "no windows" else [_split(0.5, 0.3)] * 2
    assert spec.reader(name)(_ctx(splits=splits)) is None


class _Event:
    """A raw profiler event with the methods ``trace.read`` calls."""

    def __init__(self, name, start, dur, thread=1, cuda=False, corr=0):
        self._v = (name, start, dur, thread, cuda, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[4]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return 0


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_gap_in_prefetch_wait_takes_its_name():
    """The main thread waits for its inputs (0-100 ns, no op inside), then
    steps and launches one kernel in the flow net.  The idle stretch before
    the kernel is the wait's; the device side of the two ranges, which
    spans them on the card, is not busy time."""
    events = [
        _Event("islam::prefetch_wait", 0, 100),
        _Event("islam::step", 101, 59),
        _Event("module::flowNet", 105, 50),
        _Event("cudaLaunchKernel", 110, 5, corr=7),
        _Event("islam::prefetch_wait", 0, 100, thread=0, cuda=True),
        _Event("islam::step", 101, 59, thread=0, cuda=True),
        _Event("corr_sm90_kernel", 120, 20, thread=0, cuda=True, corr=7),
    ]
    t = trace.read(_prof(events))
    assert (t.start, t.end, t.busy) == (0, 160, 20)
    assert [k.name for k in t.kernels] == ["corr_sm90_kernel"]
    assert t.kernels[0].stack == ("islam::step", "module::flowNet")
    assert t.gaps == [(120, "islam::prefetch_wait"), (20, "module::flowNet")]
    assert trace.breakdown(t)["idle_gaps"][0] == [
        "islam::prefetch_wait", 120 / 1e9]

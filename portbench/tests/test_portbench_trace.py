"""The trace readings on hand-made profiler events: the union of
overlapping intervals, the table by op, the host's runtime calls, the
device events a span caused (directly and through its autograd nodes), and
the idle gaps by host op."""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace

import pytest
import torch

from portbench import trace


@dataclass
class Ev:
    name: str
    start: float
    end: float
    thread: int = 1
    fwd_thread: int = 0
    sequence_nr: int = -1
    id: int = 0
    linked_correlation_id: int = 0
    device_type: object = torch.autograd.DeviceType.CPU
    is_user_annotation: bool = False
    time_range: SimpleNamespace = field(init=False)

    def __post_init__(self):
        self.time_range = SimpleNamespace(start=self.start, end=self.end)


CUDA = torch.autograd.DeviceType.CUDA


def kernel(name, a, b, corr, linked=0):
    return Ev(name, a, b, thread=7, id=corr, linked_correlation_id=linked, device_type=CUDA)


def test_union_and_table():
    ks = [kernel("k1", 0, 10, 1), kernel("k2", 5, 15, 2), kernel("k1", 20, 30, 3),
          kernel("k3", 40, 41, 4)]
    assert trace.busy_union_ms(ks) == pytest.approx(0.026)  # 0-15, 20-30, 40-41 us
    rows = trace.op_table(ks, steps=2)
    assert [r["op"] for r in rows] == ["k1", "k2", "k3"]
    assert rows[0]["sum_ms"] == pytest.approx(0.020) and rows[0]["calls"] == 1
    assert rows[0]["ms"] == pytest.approx(0.010)
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def test_runtime_call_counts():
    host = [Ev("cudaStreamSynchronize", 0, 1), Ev("cudaMemcpyAsync", 1, 2),
            Ev("cudaMemcpyAsync", 3, 4), Ev("cudaLaunchKernel", 5, 6), Ev("aten::mm", 5, 7)]
    assert trace.call_counts(host) == {"cudaStreamSynchronize": 1, "cudaMemcpyAsync": 2}


def test_caused_by_span_and_its_backward():
    host = [
        Ev("portbench.aggregator", 100, 200, thread=1),
        Ev("aten::mm", 110, 120, thread=1, sequence_nr=5, id=50),
        Ev("cudaLaunchKernel", 112, 113, thread=1, id=1001, linked_correlation_id=50),
        Ev("aten::add", 210, 220, thread=1, sequence_nr=6, id=60),  # after the span
        Ev("cudaLaunchKernel", 212, 213, thread=1, id=1002, linked_correlation_id=60),
        # the backward, on the autograd thread, of node 5 (made in the span)
        Ev(trace.BWD_PREFIX + ": MmBackward0", 300, 350, thread=2, fwd_thread=1,
           sequence_nr=5, id=70),
        Ev("cudaLaunchKernel", 310, 311, thread=2, id=1003, linked_correlation_id=70),
        # and of node 6 (made outside it)
        Ev(trace.BWD_PREFIX + ": AddBackward0", 360, 380, thread=2, fwd_thread=1,
           sequence_nr=6, id=80),
        Ev("cudaLaunchKernel", 361, 362, thread=2, id=1004, linked_correlation_id=80),
    ]
    dev = [kernel("fwd_k", 130, 150, 1001, 50), kernel("other", 230, 240, 1002, 60),
           kernel("bwd_k", 320, 340, 1003, 70), kernel("other_bwd", 370, 375, 1004, 80),
           # no runtime call in the trace: tied by its linked op alone
           kernel("fwd_k2", 150, 160, 1005, 50)]
    got = sorted(e.name for e in trace.caused_by(host, dev, "portbench.aggregator"))
    assert got == ["bwd_k", "fwd_k", "fwd_k2"]
    assert trace.caused_by(host, dev, "portbench.nothing") == []


def test_idle_gaps_by_host_op():
    host = [Ev("portbench.window", 0, 100), Ev("aten::item", 20, 40),
            Ev("cudaStreamSynchronize", 22, 39), Ev("aten::cat", 70, 75)]
    dev = [kernel("k", 0, 20, 1), kernel("k", 40, 70, 2), kernel("k", 75, 100, 3)]
    gaps = trace.idle_gaps(host, dev, 0, 100)
    assert gaps == [["aten::item", pytest.approx(20e-6)], ["aten::cat", pytest.approx(5e-6)]]

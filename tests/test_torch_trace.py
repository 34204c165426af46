"""The port's spans and host-wait counter (``murcl_tpu_torch/utils/trace.py``)
on the CPU, at a small size (``profile_step``'s build: 4 slides of 96
patches, D 32, feat 64, batch 8, T 3, f32), and the benchmark's six readers
of them (``portbench/metrics/``) on hand-made events.

- Without a profiler every span and step is one shared null context.
- A stage-1 and a stage-3 ``ContrastiveEngine.train_step`` give bitwise
  the same losses and parameters with and without a profiler recording.
- Under ``torch.profiler`` each span appears nested in ``murcl.step``, as
  many times a step as the engine calls its site.
- The counter keys a sync warning raised inside a span at that span and at
  the package's line (or the caller's, outside the package), prints none,
  and shows every other warning as before. It arms only on a CUDA device,
  so a CPU step here counts nothing unless the test arms it.
- The span and idle tables of ``scripts/profiling.py`` and each reader give
  the numbers worked out by hand, and the readers give None where the
  program has no spans (the parent of the tracing change).
"""

import collections
import contextlib
import inspect
import sys
import warnings
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from murcl_tpu_torch.ops import select as select_mod
from murcl_tpu_torch.scripts import profile_step, profiling
from murcl_tpu_torch.utils import trace
from portbench import spec
from portbench import trace as ptrace

T = 3
SHAPE = (4, 96, 32, 64, 8, T)
CPU = torch.device("cpu")


def _steps(stage, seeds, profiled):
    s = profile_step.build_step(CPU, SHAPE, stage=stage, dtype="float32")
    losses = []
    recording = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    with recording or contextlib.nullcontext() as prof:
        for seed in seeds:
            losses.append(s.step(seed).loss)
    params = [p.detach().clone() for m in (s.engine.model, s.engine.fc) for p in m.parameters()]
    return losses, params, prof


def test_span_without_profiler_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = trace.span("murcl.select"), trace.span("murcl.head")
    assert a is b is trace.step(CPU) is trace.step(torch.device("cuda", 0))
    assert isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        inside = trace.span("murcl.select")
        assert isinstance(inside, torch.autograd.profiler.record_function)
        assert inside.name == "murcl.select" and inside is not trace.span("murcl.select")


@pytest.mark.parametrize("stage", [1, 3])
def test_steps_bitwise_with_and_without_profiler(stage):
    plain_losses, plain_params, _ = _steps(stage, [1, 2], profiled=False)
    traced_losses, traced_params, _ = _steps(stage, [1, 2], profiled=True)
    for a, b in zip(plain_losses, traced_losses):
        assert torch.equal(a, b)
    assert len(plain_params) == len(traced_params)
    for a, b in zip(plain_params, traced_params):
        assert torch.equal(a, b)


# spans a step: stage 1 (the batched rollout) and stage 3 (T steps, the policy
# acting at each after the first)
COUNTS = {
    1: {"murcl.step": 1, "murcl.draws": 1, "murcl.select": 1, "murcl.aggregator": 1,
        "murcl.head": 2 * T, "murcl.loss": 1, "murcl.optimizer": 1},
    3: {"murcl.step": 1, "murcl.draws": T + 1, "murcl.select": T, "murcl.aggregator": T,
        "murcl.head": 2 * T, "murcl.loss": T + 1, "murcl.policy": 2 * (T - 1),
        "murcl.optimizer": 1},
}


@pytest.mark.parametrize("stage", [1, 3])
def test_spans_nest_in_the_step_once_a_call(stage):
    steps = 2
    _, _, prof = _steps(stage, range(1, steps + 1), profiled=True)
    spans = [e for e in profiling.host_events(prof) if e.name.startswith("murcl.")]
    counts = collections.Counter(e.name for e in spans)
    assert {k: v / steps for k, v in counts.items()} == COUNTS[stage]
    outer = [e for e in spans if e.name == "murcl.step"]
    for e in spans:
        if e.name != "murcl.step":
            assert any(o.thread == e.thread and o.time_range.start <= e.time_range.start
                       and e.time_range.end <= o.time_range.end for o in outer), e.name


def _select_line():
    lines, first = inspect.getsourcelines(select_mod.select_feats)
    return first + next(i for i, text in enumerate(lines) if "gather_compact(" in text)


def test_counter_keys_waits_by_span_and_package_line(monkeypatch):
    real = select_mod.gather_compact

    def waiting(*args, **kwargs):
        warnings.warn(trace.SYNC_WARNING + " (a stand-in for c10's)")
        warnings.warn("another warning")
        return real(*args, **kwargs)

    monkeypatch.setattr(select_mod, "gather_compact", waiting)
    monkeypatch.setattr(trace, "_counts_waits", lambda device: True)
    shown = warnings.showwarning
    trace.reset_host_waits()
    with pytest.warns(UserWarning) as caught:
        _steps(1, [1], profiled=True)
    assert [str(w.message) for w in caught] == ["another warning"]
    assert warnings.showwarning is shown
    site = f"murcl_tpu_torch/ops/select.py:{_select_line()}"
    assert trace.host_waits() == {("murcl.select", site): 1}
    trace.reset_host_waits()
    assert trace.host_waits() == {}


def test_counter_keys_a_caller_outside_the_package_at_its_line():
    trace.reset_host_waits()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace._Tally(), trace.span("murcl.draws"):
            first = sys._getframe().f_lineno + 1
            warnings.warn(trace.SYNC_WARNING)
        with trace._Tally():
            second = sys._getframe().f_lineno + 1
            warnings.warn(trace.SYNC_WARNING)
    assert trace.host_waits() == {("murcl.draws", f"tests/test_torch_trace.py:{first}"): 1,
                                  ("(no span)", f"tests/test_torch_trace.py:{second}"): 1}
    trace.reset_host_waits()


def test_step_on_the_cpu_counts_nothing():
    trace.reset_host_waits()
    with profile(activities=[ProfilerActivity.CPU]), pytest.warns(UserWarning):
        with trace.step(CPU):
            warnings.warn(trace.SYNC_WARNING)
    assert trace.host_waits() == {}


# Hand-made events of one step (us): the host thread 1 runs the step with a
# draws, a select, a head (whose mm makes autograd node 7), a policy and an
# optimizer span; thread 2 runs node 7's backward. Device events 1-4 come
# from launches in select, head, node 7's backward and the optimizer; 5 from
# a launch in the step outside every layer's span.
def _host(name, start, end, thread=1, id=None, **kw):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           thread=thread, id=id, device_type=torch.autograd.DeviceType.CPU,
                           is_user_annotation=False, **kw)


def _device(ident, start, end):
    return SimpleNamespace(name=f"kernel{ident}", id=ident, linked_correlation_id=0,
                           time_range=SimpleNamespace(start=start, end=end), thread=7,
                           device_type=torch.autograd.DeviceType.CUDA, is_user_annotation=False)


HOST = [
    _host("murcl.step", 0, 100), _host("murcl.draws", 0, 12), _host("murcl.select", 12, 20),
    _host("cudaLaunchKernel", 13, 14, id=1), _host("murcl.head", 30, 40),
    _host("aten::mm", 31, 34, sequence_nr=7), _host("cudaLaunchKernel", 32, 33, id=2),
    _host("murcl.policy", 41, 45), _host("murcl.optimizer", 60, 70),
    _host("cudaLaunchKernel", 61, 62, id=3), _host("cudaLaunchKernel", 95, 96, id=5),
    _host("autograd::engine::evaluate_function: MmBackward0", 80, 90, thread=2,
          fwd_thread=1, sequence_nr=7),
    _host("cudaLaunchKernel", 82, 83, thread=2, id=4),
]
DEVICE = [_device(1, 14, 16), _device(2, 33, 36), _device(4, 83, 87), _device(3, 62, 64),
          _device(5, 96, 98)]


def test_span_and_idle_tables_on_hand_made_events():
    prof = SimpleNamespace(events=lambda: HOST + DEVICE)
    assert profiling.span_table(prof, 1) == [["murcl.head", 0.007], ["murcl.select", 0.002],
                                             ["murcl.optimizer", 0.002], ["murcl.step", 0.002]]
    # gaps: 0-14 in draws, 16-33 in select, 36-62 in head, 64-83 in the
    # optimizer, 87-96 and 98-100 in the step
    idle = dict(profiling.idle_table(prof, 1))
    assert idle == pytest.approx({"murcl.draws": 0.014, "murcl.select": 0.017,
                                  "murcl.head": 0.026, "murcl.optimizer": 0.019,
                                  "murcl.step": 0.011})


def _run(host, device, steps):
    return SimpleNamespace(host=host, device=device, window_us=(0, 100), steps=steps,
                           caused_by=lambda label: ptrace.caused_by(host, device, label))


NEW = ("select.device_ms", "head.device_ms", "optimizer.device_ms", "policy.act_ms",
       "engine.host_waits_per_step", "engine.draws_idle_ms")


def test_readers_on_hand_made_events(monkeypatch):
    monkeypatch.setattr(trace, "SYNC_DEBUG", True)
    monkeypatch.setattr(trace, "_waits", collections.Counter(
        {("murcl.draws", "murcl_tpu_torch/engine/contrastive.py:1"): 5,
         ("murcl.policy", "murcl_tpu_torch/models/rlmil.py:2"): 1}))
    run = _run(HOST, DEVICE, 2)
    got = {name: spec.reader(name).read(run) for name in NEW}
    assert got == pytest.approx({"select.device_ms": 0.001, "head.device_ms": 0.0035,
                                 "optimizer.device_ms": 0.001, "policy.act_ms": 0.002,
                                 "engine.host_waits_per_step": 3.0,
                                 "engine.draws_idle_ms": 0.007})


def test_readers_give_none_without_the_programs_spans(monkeypatch):
    host = [e for e in HOST if not e.name.startswith("murcl.")]
    monkeypatch.setitem(sys.modules, "murcl_tpu_torch.utils.trace", None)
    run = _run(host, DEVICE, 2)
    assert {name: spec.reader(name).read(run) for name in NEW} == dict.fromkeys(NEW)


def test_host_waits_reader_gives_none_where_torch_cannot_flag_syncs(monkeypatch):
    monkeypatch.setattr(trace, "SYNC_DEBUG", False)
    assert spec.reader("engine.host_waits_per_step").read(_run(HOST, DEVICE, 1)) is None

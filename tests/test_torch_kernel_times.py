"""``kernel_times.device_us`` on the CPU, with ``torch.profiler`` and the
CUDA synchronise replaced by fakes (no card here):

* a session that records no matching kernel is repeated, and the first
  session that does gives the time (the matching kernels' device time over
  the calls of that session);
* after ``sessions`` empty sessions the time is ``event_ms``'s, in
  microseconds, and a line says so.
"""

import types

import pytest
import torch

from video_graph_ssl_tpu_torch import kernel_times as kt


def _event(name, us, device=torch.autograd.DeviceType.CUDA):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=types.SimpleNamespace(elapsed_us=lambda: us))


class _Profiler:
    """One fake session per ``with``: its events are the next list given."""

    def __init__(self, sessions):
        self.sessions, self.opened = list(sessions), 0

    def __call__(self, activities):
        return self

    def __enter__(self):
        self.opened += 1
        self.recorded = self.sessions.pop(0)
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self.recorded


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def install(sessions):
        prof = _Profiler(sessions)
        monkeypatch.setattr(torch.profiler, "profile", prof)
        return prof
    return install


def test_device_us_repeats_an_empty_session(fake_card):
    """An empty session, one of other kernels and CPU events only, then one
    that records the kernel: 3 sessions, 40 us over 10 calls = 4.0 us exactly."""
    prof = fake_card([[], [_event("other_kernel", 7.0), _event("sep_tc_p1_x", 5.0,
                                                               torch.autograd.DeviceType.CPU)],
                      [_event("sep_tc_p1_x", 30.0), _event("bn_sums_kernel", 10.0),
                       _event("other_kernel", 9.0)]])
    calls = []
    got = kt.device_us(lambda: calls.append(1), kt.PATTERNS["K5"], iters=10)
    assert got == 4.0
    assert prof.opened == 3
    assert len(calls) == 3 + 3 * 10


def test_device_us_falls_back_to_cuda_events(fake_card, monkeypatch, capsys):
    """Three empty sessions: the time is event_ms's 0.25 ms as 250.0 us
    exactly, and the line names the pattern."""
    prof = fake_card([[], [], []])
    monkeypatch.setattr(kt, "event_ms", lambda fn, iters: 0.25)
    got = kt.device_us(lambda: None, kt.PATTERNS["K2"], iters=5)
    assert got == 250.0
    assert prof.opened == 3
    out = capsys.readouterr().out
    assert "no kernel matching 'propagate' in 3 sessions" in out

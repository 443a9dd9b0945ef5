"""chip_smoke.py's queued_ms on the CPU, against a stand-in for the CUDA
calls it makes (events, the sleep kernel, synchronize): the sleep it asks
for, its retries with a 4x longer sleep where the host fell behind the
sleep, its error once every attempt fell behind, and the garbage collector
back on afterwards. The card's own run is chip_smoke.py's kernels phase."""

import gc
import types

import pytest
import torch

import chip_smoke

CAL_MS = 5.0                 # the stand-in's 10**7-cycle calibration sleep
TIMED_MS = 8.0               # the stand-in's events around the timed calls
WALL_S = 0.010               # the synchronised calls' wall time


class _FakeCuda:
    """torch.cuda's Event, synchronize and _sleep for queued_ms: ``behind``
    says, attempt by attempt, whether the sleep had ended when the last call
    was enqueued."""

    def __init__(self, behind):
        self.behind = list(behind)
        self.sleeps = []
        self.elapsed = [CAL_MS]

    def Event(self, enable_timing=False):
        fake = self

        class _Event:
            def record(self):
                pass

            def query(self):
                return fake.behind.pop(0)

            def elapsed_time(self, end):
                return fake.elapsed.pop(0) if fake.elapsed else TIMED_MS

        return _Event()

    def synchronize(self):
        pass

    def _sleep(self, cycles):
        self.sleeps.append(cycles)


@pytest.fixture
def fake(request, monkeypatch):
    cuda = _FakeCuda(request.param)
    for name in ("Event", "synchronize", "_sleep"):
        monkeypatch.setattr(torch.cuda, name, getattr(cuda, name))
    clock = iter([0.0, WALL_S])
    monkeypatch.setattr(chip_smoke, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    return cuda


def _sleep_ms(cycles):
    return cycles * CAL_MS / 10 ** 7


@pytest.mark.parametrize("fake", [[False], [True, False], [True, True, True, False]],
                         indirect=True, ids=["first", "second", "fourth"])
def test_queued_ms_retries_a_longer_sleep(fake):
    calls = []
    tries = len(fake.behind)
    ms = chip_smoke.queued_ms(lambda: calls.append(gc.isenabled()), iters=10, warmup=2)
    assert ms == TIMED_MS / 10
    assert calls == [True, True] + [False] * 10 * (1 + tries)   # the collector off when timed
    assert gc.isenabled()
    assert fake.sleeps[0] == 10 ** 7
    wall_ms = WALL_S * 1e3
    want = [2.0 * 4 ** i * wall_ms + 20 for i in range(tries)]
    assert [_sleep_ms(c) for c in fake.sleeps[1:]] == pytest.approx(want, abs=1e-5)


@pytest.mark.parametrize("fake", [[True] * chip_smoke.QUEUED_TRIES], indirect=True,
                         ids=["every"])
def test_queued_ms_raises_when_every_attempt_fell_behind(fake):
    with pytest.raises(RuntimeError, match="fell behind"):
        chip_smoke.queued_ms(lambda: None, iters=4, warmup=0)
    assert gc.isenabled()
    assert len(fake.sleeps) == 1 + chip_smoke.QUEUED_TRIES

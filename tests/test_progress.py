"""ProgressMeter: %/rate/ETA sampling meter (reference: src/progress.hpp)."""
import io
import sys
import time

from smoothxg_jax.utils.progress import Log, ProgressMeter


def test_meter_counts_and_line_format():
    pm = ProgressMeter(10, "t", "work", interval=0)  # no thread
    for _ in range(4):
        pm.increment()
    line = pm._line()
    assert "40.0%" in line and "4/10" in line and "ETA" in line
    pm.finish()


def test_meter_thread_reports_progress(capsys):
    pm = ProgressMeter(1000, "t", "work", interval=0.05)
    pm.increment(10)
    time.sleep(0.2)
    pm.finish()
    err = capsys.readouterr().err
    assert "[smoothxg_jax::t]" in err and "ETA" in err


def test_meter_quiet_when_done_fast(capsys):
    with ProgressMeter(5, "t", "quick", interval=5.0) as pm:
        pm.increment(5)
    assert capsys.readouterr().err == ""


def test_meter_respects_log_disabled():
    old = Log.enabled
    Log.enabled = False
    try:
        pm = ProgressMeter(5, "t", "x", interval=0.01)
        assert pm._thread is None
        pm.finish()
    finally:
        Log.enabled = old

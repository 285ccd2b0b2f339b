"""The program's own record of the traced episode: the spans and counters
of ``dragg_tpu_torch.telemetry.recording``, kept once for every reader
that asks.  Span times are the program's Unix-epoch nanoseconds, the
clock of the device trace (``harness/trace.py`` gives it in seconds).  A
program without the recording records nothing, and its readers return
None."""

import contextlib

KEY = "program_recording"


@contextlib.contextmanager
def recorded(run):
    """Keep the program's recording of the body in ``run.counters[KEY]``
    (one recording, whichever reader enters first)."""
    if KEY in run.counters:
        yield
        return
    try:
        from dragg_tpu_torch.telemetry import recording
    except ImportError:
        yield
        return
    run.counters[KEY] = None
    with recording() as rec:
        yield
    run.counters[KEY] = rec


def recording(run):
    """The recording, or None when the program kept none."""
    return run.counters.get(KEY)


def spans(rec, prefix: str) -> list:
    """The closed spans whose names start with ``prefix``."""
    return [r for r in rec.records if r["name"].startswith(prefix) and r["end_ns"] is not None]


def seconds(records) -> float:
    return sum(r["end_ns"] - r["start_ns"] for r in records) * 1e-9

"""Hang watchdog + diagnostic bundles.

Parity: the JAX package's resilience/watchdog.py, with its bundle layout,
so `tools/ptpu_doctor.py` reads a bundle this package writes (and
`read_bundle` one the JAX package wrote).

The per-dispatch deadline itself lives in the executor —
`Executor.run(timeout=)` runs the whole call (io pre-pass, device work,
completion) on a monitored worker thread (`core.dispatch.
run_with_deadline`) and raises the typed `DispatchTimeoutError`, carrying
the run's cache key, instead of hanging forever. This module adds what a
trip needs NEXT: `write_bundle` captures a self-contained diagnostic
bundle — the program, the step, feed shapes (and arrays when available),
the recent-metrics ring buffer, the structured event log, every thread's
stack, the flight-recorder trace (observability/trace) and the
persistable scope state — that `tools/ptpu_doctor.py` can inspect and
replay offline.

Bundle layout (one directory per capture):

    bundle.json    reason, fault_class, step, error, feed shapes,
                   metrics ring, events, thread stacks, wall time
    program.bin    core/program_desc bytes (when a program was given)
    feeds.npz      the failing step's feed arrays (when available)
    state.npz      persistable scope values (readers and unmaterializable
                   donated buffers recorded by name in bundle.json)
"""
import json
import os
import sys
import time
import traceback

import numpy as np

import torch

from ..core.dispatch import run_with_deadline  # noqa: F401 (re-export)
from ..core.executor import DispatchTimeoutError  # noqa: F401 (re-export)

__all__ = ["DispatchTimeoutError", "run_with_deadline", "write_bundle",
           "read_bundle", "BUNDLE_FILE"]

BUNDLE_FILE = "bundle.json"


def _thread_stacks():
    """Every live thread's current Python stack — the watchdog's answer
    to "what was the process doing when the deadline expired"."""
    frames = sys._current_frames()
    stacks = {}
    import threading
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in frames.items():
        stacks["%s (%d)" % (names.get(ident, "?"), ident)] = \
            traceback.format_stack(frame)
    return stacks


def _host(v):
    """A feed or state value as a numpy array (a bf16 tensor as float32,
    which holds every bf16 value: numpy has no bfloat16)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def write_bundle(bundle_dir, reason, fault_class=None, step=None,
                 program=None, feed=None, scope=None, metrics=None,
                 events=None, error=None):
    """Capture a diagnostic bundle under `bundle_dir` and return its
    path. Never raises for partially-capturable state: a value that
    cannot be copied to the host lands in bundle.json's
    `state_unavailable` list instead of killing the capture that exists
    to explain the failure."""
    os.makedirs(bundle_dir, exist_ok=True)
    base = "bundle_step%s" % ("NA" if step is None else int(step))
    path = os.path.join(bundle_dir, base)
    n = 0
    while os.path.exists(path):
        n += 1
        path = os.path.join(bundle_dir, "%s.%d" % (base, n))
    os.makedirs(path)

    meta = {
        "reason": str(reason),
        "fault_class": fault_class,
        "step": None if step is None else int(step),
        "error": None if error is None else repr(error),
        "wall_time": time.time(),
        "pid": os.getpid(),
        "metrics": list(metrics) if metrics else [],
        "events": list(events) if events else [],
        "thread_stacks": _thread_stacks(),
        "feed_shapes": {},
        "state_unavailable": [],
        "has_program": program is not None,
    }
    try:
        # flight-recorder dump (ARCHITECTURE.md §24): the bounded span
        # ring plus every span still OPEN at capture — for a hang this
        # is "what the pipeline was doing when it wedged", rendered by
        # `ptpu_doctor trace <bundle>`. Best-effort like everything
        # else here: a capture must never fail the capture.
        from ..observability import trace as _otrace
        meta["trace"] = _otrace.dump_jsonable()
    except Exception:  # noqa: BLE001
        pass

    if program is not None:
        from ..core import program_desc as _pd
        with open(os.path.join(path, "program.bin"), "wb") as f:
            f.write(_pd.program_to_bytes(program))
        meta["program_version"] = int(getattr(program, "_version", 0))

    feed_arrays = {}
    for name, v in (feed or {}).items():
        try:
            a = _host(v)
        except Exception:
            meta["feed_shapes"][name] = ["<unavailable>"]
            continue
        meta["feed_shapes"][name] = [list(a.shape), str(a.dtype)]
        feed_arrays[name] = a
    if feed_arrays:
        np.savez(os.path.join(path, "feeds.npz"), **feed_arrays)

    if scope is not None:
        from ..core.readers import ReaderBase
        state = {}
        for name in scope.names():
            v = scope.get(name)
            if v is None or isinstance(v, ReaderBase):
                continue
            try:
                state[name] = _host(v)
            except Exception:
                # a value that cannot reach the host: the name is the
                # diagnosis, the value is gone
                meta["state_unavailable"].append(name)
        if state:
            np.savez(os.path.join(path, "state.npz"), **state)

    with open(os.path.join(path, BUNDLE_FILE), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return path


def read_bundle(path):
    """Parse a bundle directory -> (meta, program|None, feeds|None,
    state|None). The doctor tool's loader; arrays come back as plain
    numpy dicts."""
    with open(os.path.join(path, BUNDLE_FILE)) as f:
        meta = json.load(f)
    program = None
    pb = os.path.join(path, "program.bin")
    if os.path.exists(pb):
        from ..core import program_desc as _pd
        with open(pb, "rb") as f:
            program = _pd.program_from_bytes(f.read())
    feeds = state = None
    fz = os.path.join(path, "feeds.npz")
    if os.path.exists(fz):
        with np.load(fz) as z:
            feeds = {k: z[k] for k in z.files}
    sz = os.path.join(path, "state.npz")
    if os.path.exists(sz):
        with np.load(sz) as z:
            state = {k: z[k] for k in z.files}
    return meta, program, feeds, state

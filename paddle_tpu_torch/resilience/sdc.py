"""Silent-data-corruption detection: the deterministic canary step.

Parity: the JAX package's resilience/sdc.py, over torch devices: by
default the card's CUDA devices (one on a one-card machine), or the
devices given (`devices=["cpu"]` in the tests). The canary's matmuls run
in full fp32 whatever a training path set: TF32 is switched off around
each check and the global restored after, so the digest depends on the
device and nothing else.

A flaky chip that flips bits produces *finite, plausible* wrong numbers
— no guard trips, no heartbeat stops, and the fleet trains garbage to
convergence. The industrial remedy is the one this module implements:
periodically re-dispatch a KNOWN computation (fixed inputs, no RNG, no
dropout) on a rotating device and compare the result digest against the
recorded reference. Any mismatch is, by construction, hardware (or
library nondeterminism, which on this fixed-program canary is the same
actionable event): the input bytes, program and device assignment are
identical on every check.

`CanaryChecker.check()` raises `SilentCorruptionError` carrying the
suspect device index; the Supervisor classifies it as fault class
"sdc" (default chain: abort — a bad chip is not recoverable
in-process). Across a cluster, an `ElasticWorker` escalates the
conviction with `sdc_device` and the `ClusterCoordinator` quarantines the
device (resilience/cluster.py).

Fault injection: `bitflip@N[:device]` (resilience/faults.py) corrupts
the Nth canary result — optionally waiting until the rotation lands on
a specific device index — through the module hook `_fault_hook`, the
same pulled-seam pattern as the executor/reader hooks.
"""
import collections
import hashlib

import numpy as np
import torch

__all__ = ["SilentCorruptionError", "CanaryChecker"]

# armed by resilience.faults.FaultPlan: fn(check_index, device_index,
# result_array) -> result_array (possibly corrupted). None in production.
_fault_hook = None


class SilentCorruptionError(RuntimeError):
    """A canary check's result digest diverged from the recorded
    reference: the device computed the wrong answer for a fixed input.
    `device_index` is the local index of the suspect device."""

    def __init__(self, message, device_index=None, expected=None,
                 got=None):
        super(SilentCorruptionError, self).__init__(message)
        self.device_index = device_index
        self.expected = expected
        self.got = got


class CanaryChecker(object):
    """Deterministic canary dispatch over a rotating device set.

    The canary is a few rounds of matmul + tanh over a fixed seeded
    input — enough FLOPs to exercise the matrix units where bit errors
    live, zero randomness (no dropout, no rng keys), and independent of
    the training program so its digest is stable across every training
    configuration. The reference digest is recorded on the FIRST check
    (device 0 of the rotation) — `record_reference()` forces that
    eagerly at startup, before any chip has had hours to degrade.

    The cadence cost is one small dispatch (and one host read of its
    result) per `Supervisor(sdc_every=)` steps."""

    def __init__(self, shape=(128, 128), seed=0, iters=4, devices=None,
                 history=32):
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("canary shape must be square (y @ y.T "
                             "feeds back into y), got %r" % (shape,))
        rng = np.random.RandomState(int(seed))
        self._x = np.asarray(rng.uniform(-1.0, 1.0, size=shape),
                             np.float32)
        self._iters = max(1, int(iters))
        self._devices = list(devices) if devices is not None else None
        self.reference = None
        self.checks = 0
        self.mismatches = 0
        self.last_device = None
        self.verdicts = collections.deque(maxlen=max(1, int(history)))

    # ---------------------------------------------------------- devices --
    def devices(self):
        """The rotation: the given devices, else every CUDA device (none
        is an error: the canary checks the card, never the CPU in its
        place)."""
        if self._devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if not n:
                raise RuntimeError(
                    "CanaryChecker checks the CUDA devices unless given "
                    "devices=, and torch.cuda.is_available() is False here")
            self._devices = [torch.device("cuda", i) for i in range(n)]
        self._devices = [torch.device(d) for d in self._devices]
        return self._devices

    def _compute(self, x):
        y = x
        for _ in range(self._iters):
            y = torch.tanh(y @ y.T) + 0.5 * y
        return y

    def _run_on(self, device):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            x = torch.from_numpy(self._x).to(device)
            return self._compute(x).cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    @staticmethod
    def digest(array):
        return hashlib.sha256(
            np.ascontiguousarray(array, np.float32).tobytes()
        ).hexdigest()[:16]

    # ------------------------------------------------------------ check --
    def record_reference(self):
        """Eagerly record the reference digest (one check on device 0)."""
        if self.reference is None:
            self.check()
        return self.reference

    def check(self):
        """One canary dispatch on the next device in rotation. Records
        the reference on the first call; afterwards raises
        SilentCorruptionError on any digest mismatch. Returns the
        digest when it matches."""
        devs = self.devices()
        idx = self.checks
        dev_i = idx % len(devs)
        self.checks += 1
        self.last_device = dev_i
        out = self._run_on(devs[dev_i])
        hook = _fault_hook
        if hook is not None:
            out = hook(idx, dev_i, out)
        d = self.digest(out)
        if self.reference is None:
            self.reference = d
            self.verdicts.append({"check": idx, "device": dev_i,
                                  "ok": True, "digest": d,
                                  "reference": True})
            return d
        ok = d == self.reference
        self.verdicts.append({"check": idx, "device": dev_i, "ok": ok,
                              "digest": d})
        if not ok:
            self.mismatches += 1
            raise SilentCorruptionError(
                "silent data corruption: canary digest %s != reference "
                "%s on local device %d (%s) at check %d — fixed input, "
                "fixed program: the device computed a different answer"
                % (d, self.reference, dev_i, devs[dev_i], idx),
                device_index=dev_i, expected=self.reference, got=d)
        return d

    # ----------------------------------------------------------- state --
    def status(self):
        return {"checks": int(self.checks),
                "mismatches": int(self.mismatches),
                "last_device": self.last_device,
                "reference": self.reference}

    def state_dict(self):
        """The reference digest travels with a checkpoint so a resumed
        run compares against the ORIGINAL healthy reading, not a fresh
        one taken on possibly-already-degraded hardware."""
        return {"reference": self.reference, "checks": int(self.checks),
                "mismatches": int(self.mismatches)}

    def load_state_dict(self, state):
        self.reference = state.get("reference")
        self.checks = int(state.get("checks", 0))
        self.mismatches = int(state.get("mismatches", 0))

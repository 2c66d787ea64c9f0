"""paddle_tpu_torch.resilience — supervised training that survives bad
batches, hangs and dying input pipelines.

Parity: the JAX package's resilience/ (ARCHITECTURE.md §17, §29), on the
card. Detection + policy + recovery over the executor, the checkpoints
and the reader stack:

  * guards    — device-side all-finite checks appended to the training
                step (sticky assertion flags, ONE host read a run,
                composes with steps=K inside the captured CUDA graph)
                that GATE every persistable update on the device, plus
                a host-side loss-EMA divergence detector.
  * watchdog  — per-dispatch deadlines (`Executor.run(timeout=)` → typed
                DispatchTimeoutError) and self-contained diagnostic
                bundles `tools/ptpu_doctor.py` can read.
  * Supervisor — the policy engine: per fault class (numeric / hang /
                reader / dispatch / loss_spike / divergence / sdc) an
                escalation chain of skip_batch → retry(backoff) →
                rollback(lr_scale) / rollback_skip_data → abort(bundle),
                every action in a structured event log, the flight
                recorder and a metrics counter.
  * sentinel  — streaming robust statistics (median/MAD z-scores) over
                the loss and the guard-stat grad norm, catching finite
                but wrong steps: loss spikes and slow divergence.
  * sdc       — silent-data-corruption detection: a deterministic canary
                on a rotating device, digest-compared against a recorded
                reference.
  * faults    — a deterministic fault plan (`PTPU_FAULT_PLAN` env or
                programmatic) injecting NaN feeds, reader stalls, EOFs
                and errors, dispatch exceptions, slow steps, checkpoint
                kills, finite bad batches and canary bit flips at chosen
                indices, so every recovery path above is provable.

  * heartbeat — each worker's liveness file (HeartbeatWriter) and the
                monitor over a cluster directory (HeartbeatMonitor,
                read_heartbeats; `fleet_view()` feeds
                observability.registry.watch_cluster).
  * cluster   — the plan file's helpers (write_plan, read_plan,
                default_checkpoint_dir).

Cut: the elastic cluster's ClusterCoordinator and ElasticWorker come with
the next slice of ROADMAP A10.

Quickstart:

    from paddle_tpu_torch import resilience as rz
    mgr = fluid.CheckpointManager("ckpt/")
    sup = rz.Supervisor(exe, main_prog, checkpoint_manager=mgr,
                        watchdog_timeout=120,
                        policies={"numeric": [rz.skip_batch(2),
                                              rz.rollback(2, lr_scale=0.5),
                                              rz.abort("bundles/")]})
    rz.install_numeric_guards(main_prog, loss=avg_cost)
    sup.train(10000, fetch_list=[avg_cost], checkpoint_every=100)
"""
from ..core.executor import DispatchTimeoutError, NumericalGuardError
from .faults import (FaultPlan, InjectedDispatchError, InjectedFault,
                     InjectedReaderError, active_plan)
from .guards import (DivergenceDetector, DivergenceFault,
                     install_numeric_guards)
from .sentinel import (DivergenceError, LossSpikeError, RobustWindow,
                       TrainingSentinel)
from .sdc import CanaryChecker, SilentCorruptionError
from .supervisor import (DEFAULT_POLICIES, FAULT_CLASSES, Action,
                         Supervisor, TrainingAborted, abort, retry,
                         rollback, rollback_skip_data, skip_batch)
from .watchdog import read_bundle, write_bundle
from .heartbeat import HeartbeatMonitor, HeartbeatWriter, read_heartbeats
from .cluster import default_checkpoint_dir, read_plan, write_plan

__all__ = [
    "Supervisor", "TrainingAborted", "Action", "skip_batch", "retry",
    "rollback", "rollback_skip_data", "abort", "DEFAULT_POLICIES",
    "FAULT_CLASSES",
    "TrainingSentinel", "RobustWindow", "LossSpikeError",
    "DivergenceError", "CanaryChecker", "SilentCorruptionError",
    "install_numeric_guards", "DivergenceDetector", "DivergenceFault",
    "NumericalGuardError", "DispatchTimeoutError",
    "FaultPlan", "InjectedFault", "InjectedDispatchError",
    "InjectedReaderError", "active_plan",
    "write_bundle", "read_bundle",
    "HeartbeatWriter", "HeartbeatMonitor", "read_heartbeats",
    "write_plan", "read_plan", "default_checkpoint_dir",
]

"""The cluster directory's plan file: the helpers the serving and metrics
side reads.

Parity: the JAX package's resilience/cluster.py, its plan-file helpers
only (`PLAN_FILE`, `default_checkpoint_dir`, `write_plan`, `read_plan`),
copied: the plan is the same JSON document, published by the same
atomic write, so a cluster directory written by either package reads in
the other. `observability.registry.watch_cluster` reads the coordinator's
quarantine list through `read_plan`.

The next slice of ROADMAP A10 ports the rest of the module: the
`ClusterCoordinator` (the plan's owner: fence, rollback, reshard,
quarantine) and the `ElasticWorker` (a guarded training loop that
follows the plan, with its HeartbeatWriter).
"""
import json
import os
import time

from ..core.utils import atomic_write_json

__all__ = ["PLAN_FILE", "default_checkpoint_dir", "write_plan", "read_plan"]

PLAN_FILE = "plan.json"


def default_checkpoint_dir(cluster_dir):
    """Coordinator and workers must agree on the snapshot root; this is
    the shared default under the cluster directory."""
    return os.path.join(str(cluster_dir), "ckpt")


def write_plan(cluster_dir, plan):
    """Atomically publish `plan` (tmp + fsync + os.replace: readers never
    see a torn document, and the plan survives power loss). Returns the
    plan with wall_time stamped."""
    plan = dict(plan, wall_time=time.time())
    os.makedirs(str(cluster_dir), exist_ok=True)
    atomic_write_json(os.path.join(str(cluster_dir), PLAN_FILE), plan,
                      fsync=True, indent=1, sort_keys=True)
    return plan


def read_plan(cluster_dir):
    """The current plan, or None before one is published. A transiently
    unreadable file reads as None (an atomic replace makes that a race,
    not a corruption)."""
    try:
        with open(os.path.join(str(cluster_dir), PLAN_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None

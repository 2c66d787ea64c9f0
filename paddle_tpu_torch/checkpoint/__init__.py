"""paddle_tpu_torch.checkpoint — fault-tolerant asynchronous checkpointing.

Parity: the JAX package's checkpoint package, on the same on-disk layout,
so each package restores the other's snapshots. A `CheckpointManager`
captures full training state at a step boundary — persistables and
optimizer accumulators, outer in-graph reader positions, the Scope seed
cursor, the step and the program itself — publishes it atomically (temp
dir + fsync + one rename), writes asynchronously on a background thread
with a bounded in-flight budget, hash-verifies on load and walks back to
the newest valid snapshot on corruption, and garbage-collects with a
`max_to_keep` + `keep_every_n_steps` policy.

    mgr = checkpoint.CheckpointManager("ckpt/", max_to_keep=5)
    step = mgr.restore(program=main, executor=exe) or 0
    while step < total:
        exe.run(main, ...); step += 1
        if step % 100 == 0:
            mgr.save(step, program=main)         # async, no host sync
    mgr.close()

Training N steps straight through is bit-identical to training K,
stopping, and resuming from the step-K snapshot (params, optimizer
moments, reader position, per-step seeds), eager and under steps=K, and a
kill -9 at any point of a save never leaves `restore` pointing at a torn
snapshot. `io.save_checkpoint` / `load_checkpoint` are thin shims over
the manager.
"""
from .manager import CheckpointManager, SaveHandle, skip_reader_records
from .retention import RetentionPolicy, apply_retention
from .snapshot import (find_valid_snapshot, list_steps, load_manifest,
                       load_verified_arrays, read_snapshot_meta,
                       verify_snapshot, verify_snapshot_light)

__all__ = [
    "CheckpointManager", "SaveHandle", "RetentionPolicy",
    "apply_retention", "find_valid_snapshot", "list_steps",
    "load_manifest", "load_verified_arrays", "read_snapshot_meta",
    "skip_reader_records", "verify_snapshot", "verify_snapshot_light",
]

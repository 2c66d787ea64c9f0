"""Snapshot retention: which published snapshots survive a new save.

Parity: the JAX package's checkpoint/retention.py.

`max_to_keep` bounds the rolling window (newest N snapshots);
`keep_every_n_steps` additionally pins periodic milestones (step % n == 0)
outside that window — the classic "keep the last 5 plus every 1000th"
policy. `max_to_keep=None` (or 0) keeps everything, which is also the
legacy io.save_checkpoint behavior the shim preserves by default.

Applied by the CheckpointManager's writer thread after each successful
save (the just-written step is protected even if the policy would drop
it); the snapshot layout is the JAX package's, so its offline tools
(`tools/ptpu_ckpt.py gc`) work on the port's snapshots too.
"""
import shutil

from . import snapshot as _snap

__all__ = ["RetentionPolicy", "apply_retention"]


class RetentionPolicy(object):
    def __init__(self, max_to_keep=5, keep_every_n_steps=None):
        self.max_to_keep = None if not max_to_keep else int(max_to_keep)
        self.keep_every_n_steps = (None if not keep_every_n_steps
                                   else int(keep_every_n_steps))
        if self.max_to_keep is not None and self.max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1 or None")
        if self.keep_every_n_steps is not None \
                and self.keep_every_n_steps < 1:
            raise ValueError("keep_every_n_steps must be >= 1 or None")

    def to_delete(self, steps, protect=()):
        """Steps to garbage-collect, given all published steps."""
        if self.max_to_keep is None:
            return []
        steps = sorted(set(int(s) for s in steps))
        keep = set(steps[-self.max_to_keep:])
        if self.keep_every_n_steps:
            keep.update(s for s in steps
                        if s % self.keep_every_n_steps == 0)
        keep.update(int(p) for p in protect)
        return [s for s in steps if s not in keep]

    def __repr__(self):
        return "RetentionPolicy(max_to_keep=%r, keep_every_n_steps=%r)" % (
            self.max_to_keep, self.keep_every_n_steps)


def apply_retention(checkpoint_dir, policy, protect=()):
    """Delete snapshots the policy rejects; returns the deleted steps.
    Also sweeps dead writers' tmp droppings — GC is the natural place to
    reclaim a killed save's partial directory."""
    _snap.clean_stale_tmp(checkpoint_dir)
    by_step = dict(_snap.list_steps(checkpoint_dir))
    doomed = policy.to_delete(by_step, protect=protect)
    deleted = []
    for s in doomed:
        try:
            shutil.rmtree(by_step[s])
            deleted.append(s)
        except OSError:
            pass  # concurrent GC / already gone: not worth failing a save
    return deleted

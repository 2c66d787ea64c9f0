"""Block → parameter-server assignment policies.

Parity: python/paddle/fluid/distributed_spliter.py (round_robin, hash_name).
The assignment decides which logical "pserver" owns each parameter block;
under a ParallelExecutor the owners become shards of a mesh axis instead of
processes, with the same placement policy (and load balance). A copy of
the JAX package's module.
"""

__all__ = ["round_robin", "hash_name"]


def round_robin(varlist, pserver_endpoints):
    """Distribute variables over endpoints cyclically (≈ equal counts)."""
    return [pserver_endpoints[i % len(pserver_endpoints)]
            for i in range(len(varlist))]


def hash_name(varlist, pserver_endpoints):
    """Deterministic name-hash placement (stable across runs/processes)."""
    def _hash(name):
        # stable across interpreter runs (unlike builtin hash of str)
        h = 0
        for ch in name:
            h = (h * 31 + ord(ch)) & 0x7FFFFFFF
        return h
    return [pserver_endpoints[_hash(v if isinstance(v, str) else v.name)
                              % len(pserver_endpoints)]
            for v in varlist]

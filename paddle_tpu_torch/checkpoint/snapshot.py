"""On-disk snapshot format + the atomicity protocol.

Parity: the JAX package's checkpoint/snapshot.py, byte for byte in its
layout, so each package verifies and restores the other's snapshots.
One snapshot = one `step_<N>/` directory under the checkpoint root:

    step_42/
      <var>.npy ...      one file per persistable (save_vars naming, so
                         io.load_persistables reads it unchanged)
      manifest.json      var -> {file, shape, dtype, is_param, sha256,
                         owner?}  (superset of the io.save_vars manifest)
      program.bin        core/program_desc bytes of the training program
      snapshot.json      step, seed cursor, reader states, program hash,
                         manifest hash — the root of the hash tree

Atomicity (the "kill -9 anywhere" contract, tested by fault injection):
every file is written + fsync'd inside a `.tmp_step_<N>.<pid>` directory,
the directory itself is fsync'd, then ONE `os.rename` publishes it as
`step_<N>` and the parent directory is fsync'd. A crash before the rename
leaves only an ignored tmp dir; after it, a complete snapshot. `LATEST`
is a convenience pointer updated the same way (tmp + fsync + `os.replace`)
AFTER the snapshot exists — readers never trust it over the directory
listing, so a crash between rename and pointer update is harmless.

Verification: `snapshot.json` carries the sha256 of `manifest.json` and
of `program.bin`; the manifest carries the sha256 of every array file.
`verify_snapshot` walks that tree; `find_valid_snapshot` walks step dirs
newest-first and returns the first one that verifies — a bit-flipped or
torn snapshot is skipped, never half-loaded. Directories written by the
pre-manager `io.save_checkpoint` (manifest without hashes, no
snapshot.json) verify in "legacy" mode: files must exist and the manifest
must parse, but contents are unhashed.

Values reach the writer as host arrays or as the manager's captured
copies (anything with `to_numpy()`).
"""
import errno
import hashlib
import json
import os
import shutil
import signal

import numpy as np

from ..core.utils import fsync_dir as _fsync_dir
from ..core.utils import write_bytes_fsync as _write_bytes

SNAPSHOT_FILE = "snapshot.json"
MANIFEST_FILE = "manifest.json"
PROGRAM_FILE = "program.bin"
LATEST_FILE = "LATEST"
STEP_PREFIX = "step_"
TMP_PREFIX = ".tmp_"
FORMAT_VERSION = 1

__all__ = [
    "write_snapshot", "verify_snapshot", "verify_snapshot_light",
    "find_valid_snapshot", "load_verified_arrays", "list_steps",
    "step_dir_name", "read_snapshot_meta", "load_manifest",
    "read_latest_pointer", "clean_stale_tmp", "sha256_file",
    "SNAPSHOT_FILE", "MANIFEST_FILE", "PROGRAM_FILE", "LATEST_FILE",
]


# --------------------------------------------------------------- faults --
_fault_counter = {"n": 0}

# An armed resilience.FaultPlan points this at its checkpoint-crossing
# hook (`ckpt_kill@N`); the PTPU_CKPT_FAULT_AT env var works without
# it (its counter only advances while it is set, preserving the sweep
# contract).
_fault_hook = None


def _maybe_fault():
    """Torn-write fault injection (tests only): when PTPU_CKPT_FAULT_AT=N
    is set, the Nth crossing of any injection point SIGKILLs the process —
    no atexit, no cleanup, exactly like a preemption mid-save. Injection
    points bracket every durability step of the write protocol, so a test
    sweeping N proves no kill point can publish a torn snapshot."""
    target = os.environ.get("PTPU_CKPT_FAULT_AT")
    if target:
        n = _fault_counter["n"]
        _fault_counter["n"] = n + 1
        if n == int(target):
            os.kill(os.getpid(), signal.SIGKILL)
        return
    if _fault_hook is not None:
        _fault_hook()  # FaultPlan keeps its own crossing counter


# ---------------------------------------------------------------- bytes --
def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


_sha256_file = sha256_file


def step_dir_name(step):
    return "%s%d" % (STEP_PREFIX, int(step))


def _safe_name(var_name):
    return var_name.replace("/", "__")


# ---------------------------------------------------------------- write --
def write_snapshot(checkpoint_dir, step, values, meta, program_bytes=None):
    """Write one snapshot atomically; returns the published directory.

    values: iterable of (var_name, entry_meta, value) — entry_meta is
    folded into the manifest entry (is_param, owner, ...). Values are
    brought to the host here, one at a time, so a caller handing device
    copies pays the device->host wait on THIS thread — the manager calls
    this from its background writer.
    meta: snapshot.json payload (seed_cursor, reader_states, ...).
    """
    os.makedirs(checkpoint_dir, exist_ok=True)
    final = os.path.join(checkpoint_dir, step_dir_name(step))
    tmp = os.path.join(checkpoint_dir,
                       "%s%s.%d" % (TMP_PREFIX, step_dir_name(step),
                                    os.getpid()))
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {}
    for var_name, entry_meta, value in values:
        _maybe_fault()
        arr = value.to_numpy() if hasattr(value, "to_numpy") \
            else np.asarray(value)
        fname = _safe_name(var_name) + ".npy"
        fpath = os.path.join(tmp, fname)
        with open(fpath, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        entry = {"file": fname, "shape": list(arr.shape),
                 "dtype": str(arr.dtype), "sha256": _sha256_file(fpath)}
        entry.update(entry_meta or {})
        manifest[var_name] = entry

    _maybe_fault()
    manifest_path = os.path.join(tmp, MANIFEST_FILE)
    _write_bytes(manifest_path,
                 json.dumps(manifest, indent=1).encode("utf-8"))

    snap = {"format_version": FORMAT_VERSION, "step": int(step),
            "manifest_sha256": _sha256_file(manifest_path)}
    snap.update(meta or {})
    if program_bytes is not None:
        _maybe_fault()
        ppath = os.path.join(tmp, PROGRAM_FILE)
        _write_bytes(ppath, program_bytes)
        snap["program"] = {"file": PROGRAM_FILE,
                           "sha256": _sha256_file(ppath)}
    _maybe_fault()
    # snapshot.json is the root of the hash tree and nothing above hashes
    # IT — so it carries its own content hash (computed over the
    # canonical serialization minus this field), making an in-file
    # bit-flip that stays valid JSON (a tweaked seed_cursor, a swapped
    # manifest hash) detectable instead of silently trusted
    snap["self_sha256"] = hashlib.sha256(
        json.dumps(snap, indent=1, sort_keys=True).encode()).hexdigest()
    _write_bytes(os.path.join(tmp, SNAPSHOT_FILE),
                 json.dumps(snap, indent=1, sort_keys=True).encode())
    _fsync_dir(tmp)

    # the commit point: everything above is invisible until this rename
    _maybe_fault()
    old = None
    if os.path.exists(final):
        # re-saving an existing step: never leave a window with NO valid
        # snapshot at this step — park the old dir aside first
        old = final + ".old.%d" % os.getpid()
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
        # a kill HERE leaves step_N absent but step_N.old.<pid> complete:
        # clean_stale_tmp renames it back once the writer pid is dead
        _maybe_fault()
    os.rename(tmp, final)
    _fsync_dir(checkpoint_dir)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)

    # LATEST is a hint for humans/tools; loads trust the directory walk,
    # so a kill between the rename above and this pointer is harmless
    _maybe_fault()
    lpath = os.path.join(checkpoint_dir, LATEST_FILE)
    _write_bytes(lpath + ".tmp.%d" % os.getpid(),
                 ("%d\n" % int(step)).encode())
    _maybe_fault()
    os.replace(lpath + ".tmp.%d" % os.getpid(), lpath)
    _fsync_dir(checkpoint_dir)
    _maybe_fault()
    return final


# ----------------------------------------------------------------- read --
def list_steps(checkpoint_dir):
    """[(step, path)] ascending for every published step_<N> directory."""
    out = []
    try:
        entries = os.listdir(checkpoint_dir)
    except OSError as e:
        if e.errno in (errno.ENOENT, errno.ENOTDIR):
            return []
        raise
    for e in entries:
        if not e.startswith(STEP_PREFIX) or ".old." in e:
            continue
        try:
            step = int(e[len(STEP_PREFIX):])
        except ValueError:
            continue
        path = os.path.join(checkpoint_dir, e)
        if os.path.isdir(path):
            out.append((step, path))
    return sorted(out)


def read_latest_pointer(checkpoint_dir):
    """The LATEST hint, or None. Never authoritative: loads walk the
    directory listing so a stale/absent pointer can't hide a snapshot."""
    try:
        with open(os.path.join(checkpoint_dir, LATEST_FILE)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def load_manifest(snapshot_path):
    with open(os.path.join(snapshot_path, MANIFEST_FILE)) as f:
        return json.load(f)


def read_snapshot_meta(snapshot_path):
    """snapshot.json contents; legacy dirs (pre-manager io.save_checkpoint
    layout) synthesize {"format_version": 0, "legacy": True, step}."""
    spath = os.path.join(snapshot_path, SNAPSHOT_FILE)
    if not os.path.exists(spath):
        base = os.path.basename(os.path.normpath(snapshot_path))
        try:
            step = int(base[len(STEP_PREFIX):]) \
                if base.startswith(STEP_PREFIX) else None
        except ValueError:
            step = None
        return {"format_version": 0, "legacy": True, "step": step}
    with open(spath) as f:
        return json.load(f)


def verify_snapshot(snapshot_path, deep=True):
    """-> list of problem strings (empty == snapshot is valid).

    Hashed snapshots verify the full tree: snapshot.json -> manifest
    sha256 -> per-file sha256 -> program sha256. deep=False checks
    existence + manifest hash only (cheap liveness probe). Legacy dirs
    (no snapshot.json) verify structurally: parseable manifest, every
    referenced file present.
    """
    problems = []
    manifest_path = os.path.join(snapshot_path, MANIFEST_FILE)
    try:
        manifest = load_manifest(snapshot_path)
    except (OSError, ValueError) as e:
        return ["unreadable manifest: %s" % e]
    try:
        # corruption of snapshot.json itself must read as "this snapshot
        # is invalid" (walk-back), never as a crash out of the load path
        meta = read_snapshot_meta(snapshot_path)
    except (OSError, ValueError) as e:
        return ["unreadable snapshot.json: %s" % e]
    legacy = meta.get("legacy", False)
    if legacy and any("sha256" in e for e in manifest.values()):
        # hashed manifests are manager-written: a missing snapshot.json
        # is a DELETED hash-tree root, not the pre-manager legacy layout
        return ["manager-written snapshot (hashed manifest) is missing "
                "its snapshot.json"]

    if not legacy:
        meta = dict(meta)
        want_self = meta.pop("self_sha256", None)
        got_self = hashlib.sha256(
            json.dumps(meta, indent=1,
                       sort_keys=True).encode()).hexdigest()
        if want_self != got_self:
            problems.append("snapshot.json content hash mismatch "
                            "(recorded %s)" % want_self)
        want = meta.get("manifest_sha256")
        if want != _sha256_file(manifest_path):
            problems.append("manifest.json hash mismatch (recorded %s)"
                            % want)
        prog = meta.get("program")
        if prog:
            ppath = os.path.join(snapshot_path, prog["file"])
            if not os.path.exists(ppath):
                problems.append("program file %r missing" % prog["file"])
            elif deep and _sha256_file(ppath) != prog.get("sha256"):
                problems.append("program file %r hash mismatch"
                                % prog["file"])
    for name, entry in manifest.items():
        fpath = os.path.join(snapshot_path, entry["file"])
        if not os.path.exists(fpath):
            problems.append("var %r: file %r missing" % (name,
                                                         entry["file"]))
            continue
        if legacy or not deep:
            continue
        want = entry.get("sha256")
        if want is None:
            problems.append("var %r: manifest entry carries no hash but "
                            "snapshot.json is hashed" % name)
        elif _sha256_file(fpath) != want:
            problems.append("var %r: file %r hash mismatch"
                            % (name, entry["file"]))
    return problems


def load_verified_arrays(snapshot_path, manifest=None, names=None):
    """Read each array file ONCE: hash the bytes in memory against the
    manifest's recorded sha256 (hashed snapshots; legacy dirs load
    unverified) and np.load from those same bytes — the restore path's
    single-pass alternative to verify-then-load, which would cold-read
    every file twice and leave a verify-to-load corruption window.
    `names` restricts to a subset (e.g. a pruned program's persistables).
    Raises ValueError on any hash mismatch, OSError on unreadable files.
    Returns {var_name: np.ndarray}."""
    import io as _io
    if manifest is None:
        manifest = load_manifest(snapshot_path)
    legacy = read_snapshot_meta(snapshot_path).get("legacy", False)
    out = {}
    for name, entry in manifest.items():
        if names is not None and name not in names:
            continue
        with open(os.path.join(snapshot_path, entry["file"]), "rb") as f:
            raw = f.read()
        want = entry.get("sha256")
        if not legacy and want is not None \
                and hashlib.sha256(raw).hexdigest() != want:
            raise ValueError("var %r: file %r hash mismatch"
                             % (name, entry["file"]))
        out[name] = np.load(_io.BytesIO(raw))
    return out


def verify_snapshot_light(snapshot_path):
    """Cheap validity probe for load paths that verify arrays AS they
    read them (load_verified_arrays): structure + manifest hash
    (verify_snapshot deep=False) plus the recorded program's own sha256
    — everything except hashing the array payloads. -> problem list."""
    problems = verify_snapshot(snapshot_path, deep=False)
    if problems:
        return problems
    prog = read_snapshot_meta(snapshot_path).get("program")
    if prog:
        try:
            if sha256_file(os.path.join(snapshot_path,
                                        prog["file"])) != prog.get("sha256"):
                problems.append("program file %r hash mismatch"
                                % prog["file"])
        except OSError as e:
            problems.append("program file unreadable: %s" % e)
    return problems


def find_valid_snapshot(checkpoint_dir, step=None, deep=True):
    """Newest snapshot that verifies, as (step, path) — or None.

    step pins an exact snapshot (corrupt -> None). Otherwise step dirs
    are walked newest-first: this is what makes a torn LAST save or a
    bit-flipped file recoverable — load falls back to the newest snapshot
    whose hash tree is intact, and LATEST staleness is irrelevant."""
    if step is not None:
        path = os.path.join(checkpoint_dir, step_dir_name(step))
        if os.path.isdir(path) and not verify_snapshot(path, deep=deep):
            return int(step), path
        return None
    for s, path in reversed(list_steps(checkpoint_dir)):
        if not verify_snapshot(path, deep=deep):
            return s, path
    return None


def clean_stale_tmp(checkpoint_dir):
    """Sweep dead writers' droppings (a crashed or killed save): remove
    .tmp_step_* / LATEST.tmp.* files, and RECOVER step_*.old.* dirs — a
    kill between "park the old step dir" and "publish the new one" of a
    same-step re-save leaves the parked dir as the only copy of that
    step, so it is renamed back into place, not deleted. Live writers
    are left alone."""
    removed = []
    try:
        entries = os.listdir(checkpoint_dir)
    except OSError:
        return removed
    for e in entries:
        is_tmp = e.startswith(TMP_PREFIX) or ".old." in e or ".tmp." in e
        if not is_tmp:
            continue
        try:
            pid = int(e.rsplit(".", 1)[-1])
        except ValueError:
            continue  # no writer-pid suffix: not our dropping, hands off
        if pid == os.getpid():
            continue  # this process's in-flight save
        try:
            os.kill(pid, 0)
            continue  # writer still alive: not ours to clean
        except ProcessLookupError:
            pass  # dead: safe to sweep
        except PermissionError:
            continue  # alive under another uid: not ours to clean
        except OSError:
            pass
        path = os.path.join(checkpoint_dir, e)
        if ".old." in e:
            final = path.rsplit(".old.", 1)[0]
            if not os.path.exists(final) and os.path.isdir(path):
                try:
                    os.rename(path, final)  # orphaned park: restore it
                    removed.append(e)
                except OSError:
                    pass
                continue
        try:
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
            removed.append(e)
        except OSError:
            pass
    return removed

"""Persistent content-addressed compile cache (DESIGN.md §8).

Production use of the DSE is compile-once/serve-many: the same program is
recompiled on every process start, every retune, every CI run.  This module
makes repeat compiles O(lookup) by keying schedules and whole Pareto
frontiers on a *program fingerprint* — a generalization of
``deps.iteration_space_key`` that covers everything the compiled artifact
depends on:

  * the iteration spaces (loop structure, bounds, pragmas, peel/tile/fusion
    markers) and every affine access function,
  * array shapes, widths, storage kinds, ports and partitioning,
  * the op-latency table,
  * the textual pass-pipeline applied on top of the program,
  * the resource-model mode, and
  * a scheduler *version salt* (``SCHEDULER_SALT``) — bumped whenever the
    scheduler, the transforms or the resource model change semantics, so
    stale entries from an older compiler can never be replayed.

Unlike ``iteration_space_key`` the fingerprint is **uid-free** (node
identities are walk positions, not the process-local ``ir._uid`` counter),
which is what lets entries persist across processes: schedules are packed
positionally (``pack_schedule``/``unpack_schedule``) and rehydrated onto a
freshly built program whose uids differ.

Store layout: one JSON blob per entry under ``$REPRO_HLS_CACHE_DIR`` (default
``~/.cache/repro-hls-torch``), sharded by the first two key hex digits.  Writes are
atomic (temp file + ``os.replace``) so concurrent writers never corrupt the
store — the worst case is both doing the same work and one rename winning.
The store is size-bounded: an LRU sweep (by mtime; reads ``os.utime`` their
entry) evicts the oldest entries past ``max_entries``/``max_bytes``.

Correctness contract (tested differentially in tests/test_cache.py): a cache
hit must be byte-identical to a cold compile — same ``theta``/``iis``/
latency/resource vector — and any corrupt, truncated or stale-salt entry is
detected, discarded and recompiled.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional

from . import faults
from .ir import ArithOp, ConstOp, LoadOp, Loop, Program, StoreOp

# Version salt: bump whenever the scheduler, a transform, or the resource
# model changes behavior — persisted entries with a different salt are
# invalid by definition and are discarded on read.
# 7: checksummed wrapper format + Schedule/frontier provenance fields.
SCHEDULER_SALT = "repro-hls-7"

DEFAULT_MAX_ENTRIES = 4096
DEFAULT_MAX_BYTES = 256 << 20  # 256 MiB


# ---------------------------------------------------------------------------
# Program fingerprint
# ---------------------------------------------------------------------------


def program_text(p: Program) -> str:
    """Canonical uid-free description of everything a schedule depends on.

    Node identity is the walk position (preorder) + depth, which pins the
    loop tree shape; ``fuse_group`` ids (global-counter values) are
    renumbered in first-seen order.  SSA value names are included — they
    carry the def-use graph — and are deterministic per builder/transform
    invocation, so two constructions of the same program (in different
    processes) produce the same text.
    """
    parts = []
    for name in sorted(p.arrays):
        a = p.arrays[name]
        parts.append(
            f"A{name}:{a.shape}:{a.kind}:{a.ports}:{a.partition}:"
            f"{a.rd_latency}:{a.wr_latency}:{a.elem_bits}:{int(a.is_arg)}")
    parts.append("D" + ",".join(f"{k}={v}"
                                for k, v in sorted(p.op_delays.items())))
    groups: dict[int, int] = {}
    for node, anc in p.walk():
        d = len(anc)
        if isinstance(node, Loop):
            g = node.fuse_group
            if g is not None:
                g = groups.setdefault(g, len(groups))
            parts.append(
                f"L{d}:{node.ivname}:{node.lb}:{node.ub}:"
                f"{int(node.pipeline)}:{node.ii}:{int(node.unroll)}:"
                f"{int(node.peel)}:{node.tile_block}:{g}")
        elif isinstance(node, LoadOp):
            parts.append(f"R{d}:{node.array}:{node.index!r}:{node.result}")
        elif isinstance(node, StoreOp):
            parts.append(f"W{d}:{node.array}:{node.index!r}:{node.value}")
        elif isinstance(node, ArithOp):
            parts.append(f"O{d}:{node.fn}:{node.result}:"
                         + ",".join(node.args))
        elif isinstance(node, ConstOp):
            parts.append(f"C{d}:{node.value!r}:{node.result}")
        else:  # future node kinds must not silently alias
            parts.append(f"X{d}:{type(node).__name__}")
    return "|".join(parts)


def fingerprint(p: Program, *, pipeline: str = "", mode: str = "ours",
                salt: str = SCHEDULER_SALT, extra: str = "") -> str:
    """sha256 hex key over (program text, pipeline string, resource-model
    mode, scheduler salt, caller-specific extra)."""
    h = hashlib.sha256()
    for chunk in (program_text(p), pipeline, mode, salt, extra):
        h.update(chunk.encode())
        h.update(b"\x1f")
    return h.hexdigest()


def string_key(*parts: str, salt: str = SCHEDULER_SALT) -> str:
    """A content key for non-Program payloads (e.g. kernel DSE configs)."""
    h = hashlib.sha256()
    for chunk in parts + (salt,):
        h.update(str(chunk).encode())
        h.update(b"\x1f")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Positional (uid-free) schedule serialization
# ---------------------------------------------------------------------------


def pack_schedule(s) -> dict:
    """Pack a ``scheduler.Schedule`` positionally: uids become walk indices
    of ``s.program``, so the blob rehydrates onto any structurally identical
    program regardless of its process-local uids."""
    order = [n for n, _ in s.program.walk()]
    idx = {n.uid: i for i, n in enumerate(order)}
    return {
        "iis": [s.iis[n.uid] for n in order if isinstance(n, Loop)],
        "theta": sorted([idx[u], t] for u, t in s.theta.items()),
        "edges": [[idx[e.src], idx[e.snk], e.lower, e.kind, e.array]
                  for e in s.edges],
        "feasible": bool(s.feasible),
        "provenance": getattr(s, "provenance", "exact"),
    }


def unpack_schedule(q: Program, blob: dict):
    """Rehydrate a packed schedule onto ``q``.  Raises ``ValueError`` when
    the blob does not fit the program's shape (stale entry)."""
    from .deps import DepEdge
    from .scheduler import Schedule

    order = [n for n, _ in q.walk()]
    loops = [n for n in order if isinstance(n, Loop)]
    iis_list = blob["iis"]
    if len(iis_list) != len(loops):
        raise ValueError(
            f"cached schedule has {len(iis_list)} loop IIs, program has "
            f"{len(loops)} loops")
    iis = {l.uid: int(v) for l, v in zip(loops, iis_list)}
    theta = {}
    for i, t in blob["theta"]:
        if not 0 <= i < len(order):
            raise ValueError(f"cached theta index {i} out of range")
        theta[order[i].uid] = int(t)
    edges = []
    for src, snk, lower, kind, array in blob["edges"]:
        if not (0 <= src < len(order) and 0 <= snk < len(order)):
            raise ValueError("cached edge index out of range")
        edges.append(DepEdge(src=order[src].uid, snk=order[snk].uid,
                             lower=int(lower), kind=kind, array=array))
    return Schedule(program=q, iis=iis, theta=theta, edges=edges,
                    feasible=bool(blob.get("feasible", True)),
                    provenance=str(blob.get("provenance", "exact")))


# ---------------------------------------------------------------------------
# Disk store
# ---------------------------------------------------------------------------


class CacheStore:
    """A content-addressed JSON blob store with atomic writes and LRU
    eviction.  All failure modes degrade to a miss — a broken disk can slow
    compiles down but never wrong them."""

    def __init__(self, root: Optional[str] = None, *,
                 salt: str = SCHEDULER_SALT,
                 max_entries: int = DEFAULT_MAX_ENTRIES,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.root = root or default_cache_dir()
        self.salt = salt
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.repairs = 0  # corrupt entries detected, discarded, recompiled
        self._mem: dict[str, object] = {}  # in-process read-through layer

    # ------------------------------------------------------------------
    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".json")

    @staticmethod
    def _checksum(data_str: str) -> str:
        return hashlib.sha256(data_str.encode()).hexdigest()

    def get(self, key: str):
        """The entry for ``key`` or None.  Corrupt (torn write, bit flip,
        checksum mismatch) or stale-salt blobs are deleted, counted in
        ``repairs``, and reported as a miss (the caller recompiles/re-puts)."""
        obj = self._mem.get(key)
        if obj is not None:
            self.hits += 1
            return obj
        path = self._path(key)
        try:
            with open(path, "r") as f:
                raw = f.read()
            if faults.should_fire("cache_corrupt", key="get:" + key):
                # simulate a torn blob surfacing at read time
                raw = raw[:max(1, (2 * len(raw)) // 3)]
            wrapper = json.loads(raw)
            if not isinstance(wrapper, dict) or wrapper.get("salt") != self.salt:
                raise ValueError("cache salt mismatch")
            data = wrapper["data"]
            # round-tripping through json.dumps reproduces the exact string
            # the checksum was taken over at put time (canonical separators,
            # shortest-round-trip float repr, insertion-ordered dicts)
            if wrapper.get("sum") != self._checksum(
                    json.dumps(data, separators=(",", ":"))):
                raise ValueError("cache checksum mismatch")
            obj = data
        except FileNotFoundError:
            self.misses += 1
            return None
        except (OSError, ValueError, KeyError):
            try:  # corrupt or stale: discard so it cannot strike twice
                os.unlink(path)
            except OSError:
                pass
            self.repairs += 1
            faults.note("cache-repair", key=key)
            self.misses += 1
            return None
        try:
            os.utime(path)  # recency for the LRU sweep
        except OSError:
            pass
        self._mem[key] = obj
        self.hits += 1
        return obj

    def put(self, key: str, obj) -> None:
        """Atomically persist ``obj`` under ``key`` (temp file + rename:
        concurrent writers race benignly — last rename wins, both valid).
        The temp file is fsynced before the rename and the payload carries a
        checksum, so a crash mid-write leaves either the old entry or a blob
        ``get`` detects as corrupt — never a silently wrong schedule."""
        data_str = json.dumps(obj, separators=(",", ":"))
        payload = ('{"salt":%s,"sum":%s,"data":%s}'
                   % (json.dumps(self.salt),
                      json.dumps(self._checksum(data_str)), data_str))
        torn = faults.should_fire("cache_corrupt", key="put:" + key)
        if torn:
            # emulate a writer that died mid-write (no fsync/rename
            # discipline): a truncated blob lands under the final name and
            # the in-memory layer never saw the object
            payload = payload[:max(1, (2 * len(payload)) // 3)]
        else:
            self._mem[key] = obj
        path = self._path(key)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                       prefix=".tmp-", suffix=".json")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.puts += 1
            if self.puts % 32 == 0:  # amortized sweep
                self._evict()
        except OSError:
            pass  # read-only disk etc.: in-memory layer still serves

    # ------------------------------------------------------------------
    def _entries(self) -> list[tuple[float, int, str]]:
        out = []
        try:
            shards = os.scandir(self.root)
        except OSError:
            return out
        for shard in shards:
            if not shard.is_dir():
                continue
            try:
                for e in os.scandir(shard.path):
                    if e.name.endswith(".json") and \
                            not e.name.startswith(".tmp-"):
                        try:
                            st = e.stat()
                            out.append((st.st_mtime, st.st_size, e.path))
                        except OSError:
                            pass
            except OSError:
                pass
        return out

    def _evict(self) -> None:
        """Drop oldest-mtime entries until within the entry/byte bounds."""
        entries = self._entries()
        total = sum(sz for _, sz, _ in entries)
        if len(entries) <= self.max_entries and total <= self.max_bytes:
            return
        entries.sort()  # oldest first
        while entries and (len(entries) > self.max_entries
                           or total > self.max_bytes):
            _, sz, path = entries.pop(0)
            try:
                os.unlink(path)
                self.evictions += 1
            except OSError:
                pass
            total -= sz
        self._mem.clear()  # conservatively resync with disk

    def sweep(self) -> None:
        """Force an eviction sweep now (the put path amortizes it)."""
        self._evict()

    def clear(self) -> None:
        self._mem.clear()
        for _, _, path in self._entries():
            try:
                os.unlink(path)
            except OSError:
                pass

    def stats(self) -> dict:
        entries = self._entries()
        return {"hits": self.hits, "misses": self.misses, "puts": self.puts,
                "evictions": self.evictions, "repairs": self.repairs,
                "entries": len(entries),
                "bytes": sum(sz for _, sz, _ in entries)}


# ---------------------------------------------------------------------------
# Default store resolution
# ---------------------------------------------------------------------------

_STORES: dict[str, CacheStore] = {}


def default_cache_dir() -> str:
    return os.environ.get("REPRO_HLS_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-hls-torch")


def cache_enabled() -> bool:
    """The kill switch: ``REPRO_HLS_CACHE=0`` disables persistence entirely
    (every compile is cold).  The test suite runs with it off except for the
    dedicated cache tests, which point ``REPRO_HLS_CACHE_DIR`` at a tmpdir."""
    return os.environ.get("REPRO_HLS_CACHE", "1").lower() not in (
        "0", "off", "false", "")


def get_store() -> Optional[CacheStore]:
    """The process-wide store for the current cache dir, or None when the
    cache is disabled.  Re-reads the env on every call so tests can redirect
    the store mid-process."""
    if not cache_enabled():
        return None
    root = default_cache_dir()
    st = _STORES.get(root)
    if st is None:
        st = _STORES[root] = CacheStore(root)
    return st

"""Content-addressed, LRU-bounded result cache for the simulation service
(twin of the JAX package's ``service/cache.py``).

Keys are :func:`repro_torch.service.query.query_cache_key` tuples —
machine + engines + every cost/policy leaf + the canonical trace digest
(for spec-addressed queries, :func:`~repro_torch.service.query.spec_cache_key`
substitutes the recipe digest so hits skip generation too) — so a hit
means "this exact simulation already ran" and is served with zero device
work and zero kernel launches (``tests/test_torch_service.py`` asserts
that no ``sweep_lanes`` call and no new compile signature follows a
hit).  Values are full :class:`~repro_torch.core.sim.RunResult` objects
(host-side numpy), shared by reference: results are treated as immutable
by convention.

Optionally the cache spills to disk (``spill_dir``): keys are already
process-stable (dataclass reprs of plain scalars plus content digests —
no object identity anywhere), so a fresh process pointed at the same
directory serves warm hits with zero device work.  The disk tier is an
mtime-LRU with a byte cap; entries store their full key alongside the
value, so a (vanishingly unlikely) filename-hash collision or a stale
format reads as a miss, never as a wrong result.

The disk tier is *self-healing*: every entry carries a framed header
(magic ``RPTC\\x02`` + blake2b payload checksum + length, the reference's
layout byte for byte) written via temp-file + atomic rename, so a torn
write, bit rot, or truncation is detected on read — the entry is counted
(``cache.disk.corrupt``), moved to a ``quarantine/`` sidecar directory
for post-mortem, and served as a miss so the value is recomputed and
rewritten clean.  The chaos harness (:mod:`repro_torch.obs.inject`) hooks
the ``cache.disk.read`` / ``cache.disk.write`` sites to exercise exactly
these paths.

The payload is a pickle, read back by an unpickler that resolves only
``repro_torch.*``, ``numpy.*`` and builtins.  An entry the JAX package
wrote into the same directory (its keys print as the port's, so it has
the same file name) names ``repro.core.sim.RunResult``; unpickling it
would import the JAX package, so it reads as a plain miss instead.  It is
left in place and not quarantined: it is not corrupt, only another
package's, and the port's own result for that key overwrites it (last
write wins, as for any two writers of one key).
"""
from __future__ import annotations

import collections
import hashlib
import io
import os
import pickle
import tempfile
from pathlib import Path
from typing import Optional, Tuple

from ..core.sim import RunResult
from ..obs import or_null
from ..obs.inject import InjectedFault, or_null_injector

# the only modules an entry's pickle may name (see the module docstring)
_PORT_ROOTS = ("repro_torch", "numpy", "builtins")

_DISK_FORMAT = 2
# Framed entry: magic/version | blake2b-16(payload) | u64 payload length
_MAGIC = b"RPTC\x02"
_CKSUM_LEN = 16
_HEADER_LEN = len(_MAGIC) + _CKSUM_LEN + 8


def _frame(payload: bytes) -> bytes:
    cksum = hashlib.blake2b(payload, digest_size=_CKSUM_LEN).digest()
    return _MAGIC + cksum + len(payload).to_bytes(8, "big") + payload


def _unframe(record: bytes) -> bytes:
    """Payload of a framed record; raises ``ValueError`` on any sign of
    corruption (bad magic, truncation, checksum mismatch)."""
    if len(record) < _HEADER_LEN or not record.startswith(_MAGIC):
        raise ValueError("bad magic or truncated header")
    off = len(_MAGIC)
    cksum = record[off:off + _CKSUM_LEN]
    n = int.from_bytes(record[off + _CKSUM_LEN:_HEADER_LEN], "big")
    payload = record[_HEADER_LEN:]
    if len(payload) != n:
        raise ValueError("payload length mismatch (torn write?)")
    if hashlib.blake2b(payload, digest_size=_CKSUM_LEN).digest() != cksum:
        raise ValueError("payload checksum mismatch")
    return payload


class ForeignEntryError(pickle.UnpicklingError):
    """The entry names a class outside the port: another package wrote
    it."""


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] not in _PORT_ROOTS:
            raise ForeignEntryError(f"{module}.{name}")
        return super().find_class(module, name)


def _loads(payload: bytes):
    return _PortUnpickler(io.BytesIO(payload)).load()


class DiskCacheTier:
    """Pickle-file LRU keyed by a stable hash of ``repr(key)``.

    Not safe against concurrent writers of the *same* entry beyond
    last-write-wins (writes go through a temp file + atomic rename), which
    matches the cache contract: identical keys hold identical results.

    Every operation is accounted: ``hits``/``misses`` (gets),
    ``flushes`` (entries written to disk) and ``evictions`` (entries
    unlinked by the byte cap) — without them spill effectiveness is
    unmeasurable.  ``stats()`` exposes the lot; an attached
    :class:`~repro.obs.Telemetry` mirrors each count into the metrics
    registry under ``cache.disk.*``.
    """

    def __init__(self, path, max_bytes: int = 1 << 30, telemetry=None,
                 injector=None):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self.telemetry = or_null(telemetry)
        self.injector = or_null_injector(injector)
        self.hits = 0
        self.misses = 0
        self.flushes = 0       # entries written (spilled) to disk
        self.evictions = 0     # entries unlinked by the byte cap
        self.corrupt = 0       # entries failing frame/checksum validation
        # Running byte estimate so put() doesn't rescan the directory
        # every time: None = unknown (first put resyncs via _evict);
        # overwrites over-count, which only triggers an early resync.
        self._approx_bytes = None

    def _file(self, key: Tuple) -> Path:
        digest = hashlib.blake2b(repr(key).encode(), digest_size=16)
        return self.path / f"{digest.hexdigest()}.pkl"

    def _quarantine(self, f: Path) -> None:
        """Move a corrupt entry to the ``quarantine/`` sidecar for
        post-mortem (never served again; never re-detected as corrupt)."""
        qdir = self.path / "quarantine"
        try:
            qdir.mkdir(exist_ok=True)
            os.replace(f, qdir / f.name)
        except OSError:
            try:
                f.unlink()              # sidecar unavailable: just drop it
            except OSError:
                pass

    def get(self, key: Tuple) -> Optional[RunResult]:
        f = self._file(key)
        try:
            self.injector.fire("cache.disk.read", key=f.stem)
            with open(f, "rb") as fh:
                record = fh.read()
        except FileNotFoundError:
            self.misses += 1
            self.telemetry.counter("cache.disk.misses").inc()
            return None
        except (OSError, InjectedFault):
            # an I/O error (real or injected) is a miss, not corruption
            self.misses += 1
            self.telemetry.counter("cache.disk.misses").inc()
            return None
        try:
            payload = _loads(_unframe(record))
            if (payload.get("format") != _DISK_FORMAT
                    or payload.get("key") != key):
                raise ValueError("stale or colliding cache entry")
        except ForeignEntryError:
            # another package's entry: a miss, left where it is
            self.misses += 1
            self.telemetry.counter("cache.disk.misses").inc()
            return None
        except Exception:  # noqa: BLE001 — any decode failure = corrupt
            # the entry existed but failed validation: self-heal by
            # quarantining it and reporting a miss so the value is
            # recomputed and rewritten clean
            self.corrupt += 1
            self.telemetry.counter("cache.disk.corrupt").inc()
            self._quarantine(f)
            self.misses += 1
            self.telemetry.counter("cache.disk.misses").inc()
            return None
        try:
            os.utime(f)                      # refresh LRU position
        except OSError:
            pass          # read-only spill dir: the hit still counts
        self.hits += 1
        self.telemetry.counter("cache.disk.hits").inc()
        return payload["value"]

    def put(self, key: Tuple, value: RunResult) -> None:
        record = _frame(pickle.dumps(
            {"format": _DISK_FORMAT, "key": key, "value": value}))
        if len(record) > self.max_bytes:
            return
        try:
            self.injector.fire("cache.disk.write", key=self._file(key).stem)
        except InjectedFault as exc:
            if exc.kind == "corrupt":
                # simulate a torn write: half the framed record lands on
                # disk (still via atomic rename — the tear is in the
                # content, which only the checksum frame can catch)
                record = record[:max(len(record) // 2, 1)]
            else:
                return                       # injected write error: drop
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(record)
            os.replace(tmp, self._file(key))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self.flushes += 1
        self.telemetry.counter("cache.disk.flushes").inc()
        if self._approx_bytes is not None:
            self._approx_bytes += len(record)
        if self._approx_bytes is None or self._approx_bytes > self.max_bytes:
            self._evict()                    # scans once, then resyncs

    def _evict(self) -> None:
        entries = []
        for f in self.path.glob("*.pkl"):
            try:
                st = f.stat()
            except OSError:
                continue      # raced with a concurrent evictor: skip
            entries.append((st.st_mtime, st.st_size, f))
        total = sum(size for _, size, _ in entries)
        for _, size, f in sorted(entries):   # oldest mtime first
            if total <= self.max_bytes:
                break
            try:
                f.unlink()
                self.evictions += 1
                self.telemetry.counter("cache.disk.evictions").inc()
            except OSError:
                pass          # already gone elsewhere; still over-counted
            total -= size
        self._approx_bytes = total

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "flushes": self.flushes, "evictions": self.evictions,
                "corrupt": self.corrupt,
                "entries": sum(1 for _ in self.path.glob("*.pkl")),
                "quarantined": sum(
                    1 for _ in (self.path / "quarantine").glob("*.pkl"))}

    def clear(self) -> None:
        for f in self.path.glob("*.pkl"):
            try:
                f.unlink()
            except OSError:
                pass
        for f in (self.path / "quarantine").glob("*.pkl"):
            try:
                f.unlink()
            except OSError:
                pass
        self._approx_bytes = 0


class ResultCache:
    """In-memory LRU with an optional on-disk spill tier.

    ``get`` checks memory first, then disk (promoting the entry back into
    memory); ``put`` writes through to both tiers.
    """

    def __init__(self, max_entries: int = 512, spill_dir=None,
                 disk_max_bytes: int = 1 << 30, telemetry=None):
        self._data: "collections.OrderedDict[Tuple, RunResult]" = \
            collections.OrderedDict()
        self.max_entries = max_entries
        self.telemetry = or_null(telemetry)
        self.disk = (DiskCacheTier(spill_dir, disk_max_bytes,
                                   telemetry=self.telemetry)
                     if spill_dir is not None else None)
        self.hits = 0
        self.misses = 0
        self.evictions = 0     # entries dropped from the in-memory LRU

    def attach_telemetry(self, telemetry) -> None:
        """Late-bind a telemetry sink (the broker owns the Telemetry but
        callers may hand it a pre-built cache)."""
        self.telemetry = or_null(telemetry)
        if self.disk is not None:
            self.disk.telemetry = self.telemetry

    def attach_injector(self, injector) -> None:
        """Late-bind a fault injector over the disk sites (the broker
        owns the chaos plan but callers may hand it a pre-built cache)."""
        if self.disk is not None:
            self.disk.injector = or_null_injector(injector)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: Tuple) -> Optional[RunResult]:
        hit = self._data.get(key)
        if hit is None and self.disk is not None:
            hit = self.disk.get(key)
            if hit is not None:
                self._data[key] = hit        # promote; evicted LRU below
                self._trim()
        if hit is None:
            self.misses += 1
            self.telemetry.counter("cache.mem.misses").inc()
            return None
        self._data.move_to_end(key)
        self.hits += 1
        self.telemetry.counter("cache.mem.hits").inc()
        return hit

    def put(self, key: Tuple, value: RunResult) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        self._trim()
        if self.disk is not None:
            self.disk.put(key, value)

    def _trim(self) -> None:
        while len(self._data) > self.max_entries:
            self._data.popitem(last=False)
            self.evictions += 1
            self.telemetry.counter("cache.mem.evictions").inc()

    def stats(self) -> dict:
        out = {"hits": self.hits, "misses": self.misses,
               "evictions": self.evictions, "entries": len(self._data)}
        if self.disk is not None:
            out["disk"] = self.disk.stats()
        return out

    def clear(self) -> None:
        self._data.clear()
        if self.disk is not None:
            self.disk.clear()

"""LOCK fixture: guarded-attribute inference cases (parsed, never
imported). ``_hits``/``_tags`` become guarded via ``locked_bump``; every
unlocked mutation of them must be flagged, while the never-locked
``_fresh`` counter and plain reads stay silent."""

import threading


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._hits = 0
        self._tags = {}
        self._fresh = 0

    def locked_bump(self):
        with self._lock:
            self._hits += 1
            self._tags.setdefault("seen", 0)

    def racy_bump(self):
        self._hits += 1  # expect[LOCK]

    def racy_reset(self):
        self._tags = {}  # expect[LOCK]

    def racy_item_write(self):
        self._tags["seen"] = 0  # expect[LOCK]

    def unguarded_counter_ok(self):
        self._fresh += 1

    def snapshot_read_ok(self):
        return self._hits

    def closure_does_not_hold(self):
        with self._lock:
            def later():
                self._hits += 1  # expect[LOCK]
            return later

    def allowed_racy(self):
        self._hits += 1  # repro: allow[LOCK]: fixture — suppression must hold

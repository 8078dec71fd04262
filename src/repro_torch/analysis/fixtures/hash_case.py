"""HASH fixture: a miniature spec module with deliberate tag mismatches
(parsed as if it were ``api/spec.py``; never imported)."""

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field

HASHED_SECTIONS = ("source",)
HASH_EXCLUDED_FIELDS = {"source": ("throttle",)}


def _meta(help_, *, hashed=None, **kw):
    return {"help": help_, "hashed": hashed, **kw}


@dataclass(frozen=True)
class SourceSpec:
    seed: int = field(default=0, metadata=_meta("tagged right", hashed=True))
    untagged: int = field(default=1, metadata=_meta("missing the tag"))  # expect[HASH]
    mis_tagged: int = field(default=2, metadata=_meta("wrong tag", hashed=False))  # expect[HASH]
    throttle: float = field(default=0.0, metadata=_meta("carved out", hashed=True))  # expect[HASH]
    bare: int = 3  # expect[HASH]
    quirk: int = field(default=4, metadata=_meta("wrong", hashed=False))  # repro: allow[HASH]: fixture — suppression must hold

    def hash_payload(self):  # expect[HASH]
        d = dataclasses.asdict(self)
        d.pop("throttle")  # hand-listed — must consult HASH_EXCLUDED_FIELDS
        return d


@dataclass(frozen=True)
class ExecSpec:
    retries: int = field(default=2, metadata=_meta("staging leak", hashed=True))  # expect[HASH]
    out_dir: str = field(default="", metadata=_meta("staging", hashed=False))


_GROUPS = (
    ("source", SourceSpec, ""),
    ("execution", ExecSpec, ""),
)


@dataclass(frozen=True)
class PipelineSpec:
    source: SourceSpec = SourceSpec()
    execution: ExecSpec = ExecSpec()

    def content_hash(self):  # expect[HASH]
        payload = {"source": self.source.hash_payload()}
        blob = json.dumps(payload, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

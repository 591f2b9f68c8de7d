"""The per-process JSONL sharding contract of the obs sinks.

Counterpart of `dbcsr_tpu/obs/shard.py`.  The span tracer
(``DBCSR_TPU_TORCH_TRACE``) and the event bus's sink
(``DBCSR_TPU_TORCH_EVENTS``) write per-process shards under a shared
base path:

* `shard_path(base, index)`: ``t.jsonl`` and 0 give ``t.p0.jsonl`` (the
  extension stays last, so ``t.p*.jsonl`` globs the family);
* `provisional_tag()`: the ``tmp{host}-{pid}`` tag a shard opens under
  while the process index is not known;
* `process_index()`: the rank of an already initialized
  `torch.distributed` group, else None; it never initializes one (a
  one-process run settles on 0 when its sink closes);
* `expand_family(base)`: the files of a base's shard family (the
  telemetry store's replay reads them);
* `settle(base, path, fh, index)`: move a provisional shard onto its
  final ``p{index}`` name, appending onto an existing shard instead of
  replacing it, and keeping the provisional shard on an OSError.

Stdlib-only: the tracer imports it at module level, and `process_index`
looks for torch among the modules already imported.
"""

from __future__ import annotations

import os
import re
import socket
import sys


def shard_path(base: str, index) -> str:
    """The shard file of a base path: ``t.jsonl`` and 0 give ``t.p0.jsonl``."""
    root, ext = os.path.splitext(base)
    return f"{root}.p{index}{ext}"


def provisional_tag() -> str:
    """A provisional shard tag no other process shares (``tmp{host}-{pid}``)."""
    host = re.sub(r"[^A-Za-z0-9]+", "-", socket.gethostname())[:24] or "host"
    return f"tmp{host}-{os.getpid()}"


def process_index() -> int | None:
    """The rank of an initialized `torch.distributed` group, or None when
    torch is not imported or no group is initialized (never initializes
    one)."""
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None) if torch is not None else None
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return None
    return int(dist.get_rank())


def expand_family(base: str) -> list:
    """The read side: a shard base (or a concrete file or glob) to its
    family's files.  ``t.jsonl`` expands to ``t.p*.jsonl`` without the
    unsettled ``.ptmp*`` shards (a run that ended before its index was
    known); a concrete path, even a provisional one, stays itself."""
    import glob

    hits = sorted(glob.glob(base))
    if not hits and not re.search(r"\.p\d+\.", os.path.basename(base)):
        root, ext = os.path.splitext(base)
        hits = [h for h in sorted(glob.glob(f"{root}.p*{ext}"))
                if ".ptmp" not in os.path.basename(h)]
    if not hits and os.path.exists(base):
        hits = [base]
    return hits


def settle(base: str, path: str, fh, index: int) -> tuple:
    """Move shard ``path`` (open stream ``fh``, may be None) onto
    ``shard_path(base, index)``; returns the final path and a stream open
    for appending there (``(path, fh)`` unchanged when it is there
    already).  Appends onto an existing final shard; keeps the
    provisional shard on an OSError."""
    new_path = shard_path(base, int(index))
    if new_path == path:
        return path, fh
    if fh is not None:
        fh.close()
    try:
        if os.path.exists(new_path):
            with open(path) as src, open(new_path, "a") as dst:
                dst.write(src.read())
            os.remove(path)
        else:
            os.replace(path, new_path)
    except OSError:  # cross-device or locked: keep the provisional shard
        new_path = path
    return new_path, open(new_path, "a")

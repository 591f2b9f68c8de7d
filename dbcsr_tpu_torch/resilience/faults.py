"""Deterministic, seeded fault injection at the engine's trust boundaries.

Counterpart of `dbcsr_tpu/resilience/faults.py:213-382`, with the same
DSL, so one spec string fires on the same calls and corrupts the same
element by the same delta in both packages.  The sites are those of
`resilience/sites.py`: ``execute_stack`` (per stack launch, label
``driver``: "pallas_cross", "pallas", "torch" or "host"),
``prepare_stack`` and ``dense``.  A spec's *target* matches the site or
a label value, so ``pallas:raise`` fires only on base-kernel launches
and ``execute_stack:raise`` on every driver.

**Kinds**: ``raise`` (a `RuntimeError` worded like a failed CUDA
launch), ``oom`` (`torch.cuda.OutOfMemoryError` where CUDA is
available, else a `RuntimeError`; both say "out of memory", the
transient class), ``nan`` (one output element set to NaN, caught by the
finite-output check), ``flip`` (one output element plus a large finite
delta, ``2**10 + seed % 997``, at flat index ``seed % numel``: the
silent-data-corruption model only the ABFT probe and the chain
invariants see), ``hang`` (sleep ``sleep`` seconds) and ``fail`` (a
`FaultError`, for boolean sites).  ``nan`` and ``flip`` write the tensor
in place.

**DSL** (``DBCSR_TPU_TORCH_FAULTS``), specs separated by ``;``::

    target:kind[@stack{>=,<=,==,<,>}N][,prob=P][,seed=S][,times=N][,sleep=SEC]

``@stack>=N`` conditions on the spec's count of matching calls (1 on the
first), ``times=N`` caps how often it fires, and ``prob`` draws from a
per-spec `random.Random(seed)`.  The variable is read on first use;
`configure`/`clear` and the `inject_faults` context manager replace it.
With no spec installed every hook is one truth check (`active`).

Stdlib-only at import; torch is reached inside the hooks.
"""

from __future__ import annotations

import contextlib
import os
import random
import re
import threading
import time
from typing import List, Optional

_lock = threading.Lock()
_specs: List["FaultSpec"] = []
_env_parsed = False

KINDS = ("raise", "oom", "nan", "hang", "fail", "flip")


class FaultError(RuntimeError):
    """Raised for injected ``fail`` faults."""


_SPEC_RE = re.compile(
    r"^(?P<target>[A-Za-z0-9_.]+):(?P<kind>[a-z]+)"
    r"(?:@stack(?P<op>>=|<=|==|<|>)(?P<n>\d+))?$"
)


class FaultSpec:
    """One parsed fault rule (see the module docstring for the DSL)."""

    __slots__ = ("target", "kind", "op", "n", "prob", "seed", "times",
                 "sleep", "calls", "fired", "_rng")

    def __init__(self, target: str, kind: str, op: str = ">=", n: int = 0,
                 prob: float = 1.0, seed: int = 0,
                 times: Optional[int] = None, sleep: float = 30.0):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {KINDS})")
        self.target = target
        self.kind = kind
        self.op = op
        self.n = n
        self.prob = prob
        self.seed = seed
        self.times = times
        self.sleep = sleep
        self.calls = 0   # matching calls seen
        self.fired = 0   # faults actually injected
        self._rng = random.Random(seed)

    def _cond_ok(self) -> bool:
        c, n = self.calls, self.n
        return {">=": c >= n, "<=": c <= n, "==": c == n, "<": c < n, ">": c > n}[self.op]

    def matches(self, site: str, labels: dict) -> bool:
        return self.target == site or self.target in labels.values()

    def should_fire(self) -> bool:
        """Advance the matching-call counter and decide (deterministic
        given the seed and the call sequence)."""
        self.calls += 1
        if not self._cond_ok():
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        self.fired += 1
        return True

    def __repr__(self):
        cond = f"@stack{self.op}{self.n}" if self.n else ""
        return (f"FaultSpec({self.target}:{self.kind}{cond},"
                f"prob={self.prob},seed={self.seed},times={self.times})")


def parse(spec_string: str) -> List[FaultSpec]:
    """Parse a ``DBCSR_TPU_TORCH_FAULTS`` value into FaultSpecs."""
    specs = []
    for part in spec_string.split(";"):
        part = part.strip()
        if not part:
            continue
        head, *opts = part.split(",")
        m = _SPEC_RE.match(head.strip())
        if m is None:
            raise ValueError(f"bad fault spec {head!r} (want target:kind[@stack>=N])")
        kw = dict(target=m.group("target"), kind=m.group("kind"))
        if m.group("op"):
            kw["op"], kw["n"] = m.group("op"), int(m.group("n"))
        for o in opts:
            k, _, v = o.strip().partition("=")
            if k == "prob":
                kw["prob"] = float(v)
            elif k == "seed":
                kw["seed"] = int(v)
            elif k == "times":
                kw["times"] = int(v)
            elif k == "sleep":
                kw["sleep"] = float(v)
            else:
                raise ValueError(f"unknown fault option {k!r} in {part!r}")
        specs.append(FaultSpec(**kw))
    return specs


def configure(spec_string: Optional[str]) -> List[FaultSpec]:
    """Install a fault schedule (replacing any active one); None or ""
    clears it."""
    global _specs, _env_parsed
    with _lock:
        _env_parsed = True  # an explicit configuration overrides the env
        _specs = parse(spec_string) if spec_string else []
        return _specs


def clear() -> None:
    configure(None)


def _ensure_env() -> None:
    global _env_parsed
    if _env_parsed:
        return
    with _lock:
        if _env_parsed:
            return
        env = os.environ.get("DBCSR_TPU_TORCH_FAULTS")
        if env:
            _specs.extend(parse(env))
        _env_parsed = True


def active() -> bool:
    """True when any fault spec is installed: the hot-path gate in front
    of every other hook."""
    if not _env_parsed:
        _ensure_env()
    return bool(_specs)


def specs() -> List[FaultSpec]:
    _ensure_env()
    return list(_specs)


def _note(site: str, spec: FaultSpec, labels: dict) -> None:
    """Every injected fault is counted and published (with a flight
    event)."""
    from dbcsr_tpu_torch.obs import events as _events
    from dbcsr_tpu_torch.obs import metrics as _metrics

    _metrics.counter(
        "dbcsr_tpu_faults_injected_total",
        "faults injected by dbcsr_tpu_torch.resilience.faults per site/kind",
    ).inc(site=site, kind=spec.kind)
    _events.publish(
        "fault_injected",
        {"site": site, "kind": spec.kind, "target": spec.target, "fired": spec.fired,
         **{k: str(v) for k, v in labels.items()}},
        flight=("fault_injected", {"site": site, "kind": spec.kind, "target": spec.target}),
    )


def _firing_spec(site: str, kinds, labels: dict) -> Optional[FaultSpec]:
    for spec in _specs:
        if spec.kind in kinds and spec.matches(site, labels):
            if spec.should_fire():
                return spec
    return None


def maybe_inject(site: str, **labels) -> None:
    """Raise or sleep if a ``raise``/``oom``/``fail``/``hang`` spec fires
    at this site."""
    if not _specs:
        return
    spec = _firing_spec(site, ("raise", "oom", "fail", "hang"), labels)
    if spec is None:
        return
    _note(site, spec, labels)
    if spec.kind == "hang":
        time.sleep(spec.sleep)
        return
    if spec.kind == "fail":
        raise FaultError(f"injected fault at {site} ({spec!r})")
    if spec.kind == "oom":
        import torch

        err = torch.cuda.OutOfMemoryError if torch.cuda.is_available() else RuntimeError
        raise err(f"CUDA out of memory: injected device OOM at {site} "
                  f"(fault injection, {spec.target})")
    raise RuntimeError(f"CUDA error: unspecified launch failure: injected at {site} "
                       f"(fault injection, {spec.target})")


def corrupt(site: str, value, **labels):
    """Apply a firing ``nan``/``flip`` spec to ``value`` (a contiguous
    floating or complex tensor) in place and return it: ``nan`` sets one element to
    NaN, ``flip`` adds ``2**10 + seed % 997`` to one, the element at flat
    index ``seed % numel`` in both cases."""
    if not _specs:
        return value
    spec = _firing_spec(site, ("nan", "flip"), labels)
    if spec is None:
        return value
    _note(site, spec, labels)
    if value.numel() == 0 or not (value.is_floating_point() or value.is_complex()):
        return value
    flat = value.view(-1)
    idx = spec.seed % flat.numel()
    if spec.kind == "flip":
        # large but finite, exact in every engine dtype (bf16 included)
        flat[idx] += float(1 << 10) + float(spec.seed % 997)
    else:
        flat[idx] = float("nan")
    return value


def fail_probe(site: str = "probe", **labels) -> bool:
    """Boolean form for probe-style sites: True when a ``fail``/``raise``
    spec fires (``hang`` sleeps, then fails)."""
    if not _specs:
        return False
    spec = _firing_spec(site, ("raise", "fail", "hang"), labels)
    if spec is None:
        return False
    _note(site, spec, labels)
    if spec.kind == "hang":
        time.sleep(spec.sleep)
    return True


@contextlib.contextmanager
def inject_faults(spec_string: str):
    """Install a schedule for the ``with`` block and restore the previous
    one on exit::

        with inject_faults("pallas:raise,times=1"):
            multiply(...)  # the first base-kernel launch fails over
    """
    global _specs
    _ensure_env()
    with _lock:
        prev = list(_specs)
    installed = configure(spec_string)
    try:
        yield installed
    finally:
        with _lock:
            _specs = prev

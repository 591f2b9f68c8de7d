"""Workload trace capture, trace modeling, and deterministic replay.

Counterpart of `dbcsr_tpu/serve/workload.py`, in three layers:

* **Recorder** -- `on_terminal` is the `serve.queue.Request._finish`
  hook (reached through ``sys.modules``, like the attribution ledger):
  every request that reaches a terminal state is appended to a JSONL
  shard as one ``workload_request`` record -- tenant, op, priority,
  arrival time, deadline, terminal state/outcome/latency, and the
  operand SCHEMA: blockings, dtype names, pattern fingerprints and
  VALUE digests (`core.digests`, sha1 hex), never values.  Off by
  default; ``DBCSR_TPU_TORCH_WORKLOAD=<base>`` enables the sink
  (sharded per process through `obs.shard`).  With the sink off the
  hook costs one early return.

* **Trace model and synthesizer** -- `fit` reduces a trace to per-tenant
  arrival rates, burstiness (inter-arrival CV), the shape mix and the
  digest repeat structure; `synthesize` emits a scaled synthetic trace
  in the same record schema.

* **Deterministic replay** -- `request_stream(trace, seed)` is a pure
  function from (records, seed) to a replayable request stream: value
  digests map to derived generator seeds, so the same trace and seed
  give the same stream, and equal digests materialize equal values.
  `materialize` builds operands into a session on the session's device
  (memoized per digest), and `replay_submit` is the one submission
  choke point, with the ``replay_submit`` fault site.

A trace is stdlib JSON whose dtypes are names ("float64") and whose
operands are digests, so a trace either package writes replays in the
other: the port's `make_random_matrix` draws as the JAX package's does.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time

from dbcsr_tpu_torch.obs import shard as _shard

# schema stamp of workload_request records / request-stream entries:
# bump when either shape changes incompatibly
WORKLOAD_SCHEMA = 1

_lock = threading.Lock()

# "0"/"off"/unset disables the recorder entirely; a path enables the
# JSONL shard sink (like the event sink, but default-off: tracing
# every request is an operator decision, not a default)
_env = os.environ.get("DBCSR_TPU_TORCH_WORKLOAD", "")
_enabled = _env not in ("", "0", "off")

# JSONL sink state (sharded like the event bus; see obs.shard)
_sink = None          # open file handle, or None
_sink_base: str | None = None
_sink_path: str | None = None
_sink_pid_final = False


def sink_active() -> bool:
    return _sink is not None


def sink_path() -> str | None:
    """The shard file the recorder is currently writing (None = off)."""
    return _sink_path


def enable_sink(base_path: str | None = None) -> str:
    """Open the workload JSONL sink (default base:
    $DBCSR_TPU_TORCH_WORKLOAD), sharded per process like the event sink
    (`obs.shard.shard_path`); returns the actual file (`sink_path`)."""
    global _sink, _sink_base, _sink_path, _sink_pid_final
    base_path = base_path or os.environ.get("DBCSR_TPU_TORCH_WORKLOAD")
    if not base_path or base_path in ("0", "off"):
        raise ValueError("no workload sink path: pass one or set "
                         "DBCSR_TPU_TORCH_WORKLOAD")
    disable_sink()
    pid = _shard.process_index()
    with _lock:
        _sink_base = base_path
        _sink_pid_final = pid is not None
        tag = pid if pid is not None else _shard.provisional_tag()
        _sink_path = _shard.shard_path(base_path, tag)
        _sink = open(_sink_path, "a")
    return _sink_path


def disable_sink() -> None:
    """Close the sink, settling a provisional shard name on index 0."""
    global _sink
    rebind(force=True)
    with _lock:
        if _sink is not None:
            try:
                _sink.close()
            except Exception:
                pass
            _sink = None


def rebind(process_index: int | None = None, force: bool = False) -> None:
    """Settle a provisionally-named sink shard onto its final
    ``p{index}`` name (the `obs.events.rebind` contract: driven by
    `init_multihost`; ``force`` settles on 0 at close)."""
    global _sink, _sink_path, _sink_pid_final
    with _lock:
        if _sink is None or _sink_pid_final:
            return
        if process_index is None:
            process_index = _shard.process_index()
        if process_index is None:
            if not force:
                return
            process_index = 0
        _sink_pid_final = True
        _sink_path, _sink = _shard.settle(
            _sink_base, _sink_path, _sink, int(process_index))


# ------------------------------------------------------------ recording

def _operand_schema(m) -> dict:
    """The recorded schema of one operand matrix: blockings, dtype,
    occupation, pattern fingerprint and VALUE digest (hex) — never the
    values themselves (a trace is shareable without tenant data)."""
    from dbcsr_tpu_torch.core import digests as _digests
    from dbcsr_tpu_torch.core.kinds import name_of

    rows, _cols = m.entry_coords()
    nblk = len(m.row_blk_sizes) * len(m.col_blk_sizes)
    fp = _digests.digest(repr(m.pattern_fingerprint()).encode()).hex()[:16]
    return {
        "digest": _digests.matrix_value_digest(m).hex(),
        "fingerprint": fp,
        "row_blk": [int(x) for x in m.row_blk_sizes],
        "col_blk": [int(x) for x in m.col_blk_sizes],
        "dtype": name_of(m.dtype),
        "occupation": round(len(rows) / nblk, 4) if nblk else 0.0,
    }


def _record_of(req, state: str) -> dict:
    """One ``workload_request`` record from a terminal request."""
    operands: dict = {}
    params: dict = {}
    sess = req.session
    for key, val in (req.params or {}).items():
        m = None
        if isinstance(val, str):
            try:
                m = sess.get(val)
            except Exception:
                m = None
        elif hasattr(val, "pattern_fingerprint"):
            m = val
        if m is not None:
            try:
                operands[key] = _operand_schema(m)
                continue
            except Exception:
                pass  # unfinalized/closed: fall through to the scalar
        if isinstance(val, (int, float, str, bool)) or val is None:
            params[key] = val
    t_done = req.t_done if req.t_done is not None else time.time()
    return {
        "kind": "workload_request",
        "schema": WORKLOAD_SCHEMA,
        "request_id": req.request_id,
        "tenant": req.tenant,
        "op": req.op,
        "priority": req.priority,
        "t": req.t_submit,
        "deadline_s": (round(req.t_deadline - req.t_submit, 6)
                       if req.t_deadline is not None else None),
        "state": state,
        "outcome": req.outcome,
        "latency_ms": round((t_done - req.t_submit) * 1e3, 3),
        "params": params,
        "operands": operands,
    }


def on_terminal(req, state: str) -> None:
    """The `queue.Request._finish` recording hook.  MUST never raise
    into the terminal transition (the caller guards anyway) and must
    cost one early return when the sink is off."""
    if _sink is None:
        return
    try:
        rec = _record_of(req, state)
    except Exception:
        return  # recording is best-effort; the outcome stands alone
    with _lock:
        sink = _sink
        if sink is None:
            return
        try:
            sink.write(json.dumps(rec, default=str) + "\n")
        except Exception:
            return  # a full disk must not fail the request
    try:
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_workload_records_total",
            "workload-trace records captured by the serve recorder, "
            "by tenant and terminal state",
        ).inc(tenant=req.tenant, state=state)
    except Exception:
        pass


def note_replay(tenant: str, outcome: str) -> None:
    """Replay-side meter: one terminal replayed request (the load
    harness and the chaos replay case both call this, so the
    ``_collect_workload`` timeseries collector sees either)."""
    try:
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_replay_requests_total",
            "replayed workload requests by tenant and terminal outcome "
            "(load harnesses and replay drivers)",
        ).inc(tenant=tenant, outcome=outcome)
    except Exception:
        pass


# ------------------------------------------------------------- reading

def read_trace(path: str) -> list:
    """``workload_request`` records of a trace base/file (shard-family
    aware via `obs.shard.expand_family`; meta/torn lines skipped),
    sorted by arrival time then request id — the one deterministic
    order every consumer sees regardless of shard interleaving."""
    records = []
    for f in _shard.expand_family(path):
        try:
            with open(f) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail line
                    if rec.get("kind") == "workload_request":
                        records.append(rec)
        except OSError:
            continue
    records.sort(key=lambda r: (r.get("t", 0.0),
                                str(r.get("request_id", ""))))
    return records


# ------------------------------------------------------- trace modeling

def _digest_key(rec: dict) -> tuple:
    """The repeat-structure key of one request: op + the INPUT operand
    digests (the output target's values are not a cache input)."""
    return (rec.get("op", "multiply"),) + tuple(
        sorted(f"{k}:{v['digest']}"
               for k, v in (rec.get("operands") or {}).items()
               if k != "c" and v.get("digest")))


def _shape_sig(rec: dict) -> str:
    """Canonical shape-mix signature: op + scalar params + per-operand
    (blockings, dtype, occupation) — everything but the value digests."""
    ops = {}
    for k, v in (rec.get("operands") or {}).items():
        ops[k] = {kk: v.get(kk) for kk in
                  ("row_blk", "col_blk", "dtype", "occupation")}
    return json.dumps({"op": rec.get("op", "multiply"),
                       "params": rec.get("params") or {},
                       "operands": ops}, sort_keys=True)


def fit(records: list) -> dict:
    """Fit the workload model from recorded ``workload_request``
    records: per-tenant arrival rate, burstiness (inter-arrival
    coefficient of variation; ~1 = Poisson), shape mix, and digest
    repeat rate (the fraction of requests whose input-digest tuple was
    seen before — what drives the product-cache hit rate)."""
    if not records:
        return {"kind": "workload_model", "schema": WORKLOAD_SCHEMA,
                "requests": 0, "duration_s": 0.0, "tenants": {}}
    t0 = min(r.get("t", 0.0) for r in records)
    t1 = max(r.get("t", 0.0) for r in records)
    duration = max(t1 - t0, 1e-6)
    tenants: dict = {}
    for rec in records:
        tenants.setdefault(rec.get("tenant", "?"), []).append(rec)
    model: dict = {"kind": "workload_model", "schema": WORKLOAD_SCHEMA,
                   "requests": len(records),
                   "duration_s": round(duration, 6), "tenants": {}}
    for tenant, recs in sorted(tenants.items()):
        arrivals = sorted(r.get("t", 0.0) for r in recs)
        gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
        cv = 1.0
        if len(gaps) >= 2:
            mean = sum(gaps) / len(gaps)
            if mean > 0:
                var = sum((g - mean) ** 2 for g in gaps) / len(gaps)
                cv = math.sqrt(var) / mean
        seen: set = set()
        repeats = 0
        shapes: dict = {}
        for r in recs:
            key = _digest_key(r)
            if key in seen:
                repeats += 1
            seen.add(key)
            sig = _shape_sig(r)
            ent = shapes.setdefault(sig, {"weight": 0, "digest_keys": []})
            ent["weight"] += 1
            if key not in ent["digest_keys"]:
                ent["digest_keys"].append(key)
        priorities = sorted(r.get("priority", 10) for r in recs)
        deadlines = sorted(r["deadline_s"] for r in recs
                           if r.get("deadline_s") is not None)
        model["tenants"][tenant] = {
            "requests": len(recs),
            "rate_hz": round(len(recs) / duration, 6),
            "burstiness_cv": round(cv, 4),
            "repeat_rate": round(repeats / len(recs), 4),
            "priority": priorities[len(priorities) // 2],
            "deadline_s": (deadlines[len(deadlines) // 2]
                           if deadlines else None),
            "shapes": [dict(json.loads(sig), weight=ent["weight"],
                            n_digest_keys=len(ent["digest_keys"]))
                       for sig, ent in sorted(shapes.items())],
        }
    return model


def synthesize(model: dict, rate_x: float = 1.0, tenants_x: float = 1.0,
               repeat_rate: float | None = None,
               duration_s: float | None = None, seed: int = 0) -> list:
    """Synthesize a scaled trace from a fitted model, deterministically
    in ``seed``: per-tenant arrivals from the fitted rate x ``rate_x``
    (lognormal inter-arrivals reproducing the fitted burstiness CV;
    CV=1 degenerates to ~exponential), tenant count scaled by
    ``tenants_x`` (clones named ``<tenant>~N``), and the digest repeat
    structure driven by ``repeat_rate`` (default: the fitted rate).
    Returns ``workload_request`` records — the same schema
    `request_stream` replays."""
    import random

    rng = random.Random(int(seed))
    duration = float(duration_s if duration_s is not None
                     else model.get("duration_s") or 1.0)
    out = []
    for tenant, row in sorted((model.get("tenants") or {}).items()):
        clones = max(1, int(round(float(tenants_x))))
        for ci in range(clones):
            name = tenant if ci == 0 else f"{tenant}~{ci}"
            rate = max(1e-6, row["rate_hz"] * float(rate_x))
            cv = max(0.05, float(row.get("burstiness_cv", 1.0)))
            rr = float(repeat_rate if repeat_rate is not None
                       else row.get("repeat_rate", 0.0))
            # lognormal with sigma chosen so std/mean = cv
            sigma = math.sqrt(math.log(1.0 + cv * cv))
            mu = math.log(1.0 / rate) - 0.5 * sigma * sigma
            shapes = row.get("shapes") or []
            weights = [s.get("weight", 1) for s in shapes]
            t = 0.0
            i = 0
            used: list = []
            while True:
                t += rng.lognormvariate(mu, sigma)
                if t >= duration:
                    break
                shape = (rng.choices(shapes, weights=weights)[0]
                         if shapes else {"op": "multiply", "params": {},
                                         "operands": {}})
                if used and rng.random() < rr:
                    variant = rng.choice(used)
                else:
                    variant = i
                    used.append(variant)
                operands = {}
                for k, spec in (shape.get("operands") or {}).items():
                    salt = "out" if k == "c" else f"in{variant}"
                    operands[k] = dict(
                        spec,
                        digest=hashlib.sha1(
                            f"synthetic:{name}:{salt}:{k}:"
                            f"{_canon(spec)}".encode()).hexdigest())
                out.append({
                    "kind": "workload_request",
                    "schema": WORKLOAD_SCHEMA,
                    "request_id": f"synt-{name}-{i}",
                    "tenant": name,
                    "op": shape.get("op", "multiply"),
                    "priority": row.get("priority", 10),
                    "t": round(t, 6),
                    "deadline_s": row.get("deadline_s"),
                    "state": "done",
                    "outcome": "OK",
                    "latency_ms": None,
                    "params": shape.get("params") or {},
                    "operands": operands,
                })
                i += 1
    out.sort(key=lambda r: (r["t"], r["request_id"]))
    return out


def _canon(spec: dict) -> str:
    return json.dumps({k: spec.get(k) for k in
                       ("row_blk", "col_blk", "dtype", "occupation")},
                      sort_keys=True)


# --------------------------------------------------- deterministic replay

def derive_seed(digest_hex: str, seed: int) -> int:
    """The deterministic digest -> generator-seed map: equal digests
    (same recorded values) materialize equal replay values under one
    replay seed, so the recorded repeat structure — and with it the
    product-cache hit rate — reproduces."""
    h = hashlib.sha1(f"{digest_hex}:{int(seed)}".encode()).digest()
    return int.from_bytes(h[:4], "big")


def request_stream(records: list, seed: int = 0) -> list:
    """The replayable request stream of a trace: a PURE function of
    (records, seed), so two calls with the same inputs are
    bitwise-identical under ``json.dumps(..., sort_keys=True)`` —
    the determinism contract `tests/test_workload.py` pins.

    Entries carry arrival offsets from the first recorded arrival,
    replay request ids, scalar params, and per-operand materialization
    specs (blockings, dtype, occupation, digest + derived seed)."""
    recs = sorted(records, key=lambda r: (r.get("t", 0.0),
                                          str(r.get("request_id", ""))))
    t0 = recs[0].get("t", 0.0) if recs else 0.0
    stream = []
    for i, rec in enumerate(recs):
        operands = {}
        for k, spec in sorted((rec.get("operands") or {}).items()):
            dig = spec.get("digest") or f"missing-{i}-{k}"
            operands[k] = {
                "digest": dig,
                "seed": derive_seed(dig, seed),
                "row_blk": list(spec.get("row_blk") or []),
                "col_blk": list(spec.get("col_blk") or []),
                "dtype": spec.get("dtype", "float64"),
                "occupation": float(spec.get("occupation") or 0.5),
                "role": "out" if k == "c" else "in",
            }
        stream.append({
            "i": i,
            "schema": WORKLOAD_SCHEMA,
            "request_id": f"replay-{int(seed)}-{i}",
            "offset_s": round(rec.get("t", 0.0) - t0, 6),
            "tenant": rec.get("tenant", "?"),
            "op": rec.get("op", "multiply"),
            "priority": int(rec.get("priority", 10)),
            "deadline_s": rec.get("deadline_s"),
            "params": {k: rec["params"][k]
                       for k in sorted(rec.get("params") or {})},
            "operands": operands,
        })
    return stream


def materialize(session, name: str, spec: dict, cache: dict):
    """Materialize one operand spec into ``session`` (registered under
    ``name``), memoized per (tenant, digest): a repeated digest reuses
    the SAME matrix object, so its value-digest memo hits and the
    product cache sees the recorded repeat structure.  Output-role
    operands (fresh result targets) are never shared."""
    import numpy as np

    from dbcsr_tpu_torch.ops.test_methods import make_random_matrix

    key = (session.tenant, spec["digest"])
    if spec.get("role") != "out":
        hit = cache.get(key)
        if hit is not None:
            # register in THIS session too — the cache outlives
            # sessions (a new leg reopens them), and put is overwrite
            session.put(name, hit, adopt=False)
            return hit
    m = make_random_matrix(
        f"wl-{spec['digest'][:12]}", spec["row_blk"], spec["col_blk"],
        dtype=spec["dtype"],
        occupation=max(0.05, min(1.0, spec["occupation"]))
        if spec.get("role") != "out" else 0.3,
        rng=np.random.default_rng(int(spec["seed"])), device=session.device)
    session.put(name, m, adopt=(spec.get("role") == "out"))
    if spec.get("role") != "out":
        cache[key] = m
    return m


def stage_entry(session, entry: dict, cache: dict) -> dict:
    """Materialize every operand of one stream entry into ``session``
    and return the engine-submit kwargs (operand names + scalar
    params).  Operand ``name`` is digest-derived so repeats reference
    the same registered matrix."""
    kwargs = dict(entry.get("params") or {})
    for k, spec in sorted((entry.get("operands") or {}).items()):
        name = (f"{k}-{spec['digest'][:12]}" if spec.get("role") != "out"
                else f"{k}-{entry['request_id']}")
        materialize(session, name, spec, cache)
        kwargs[k] = name
    return kwargs


def replay_submit(engine, session, entry: dict, kwargs: dict,
                  request_id: str | None = None):
    """The ONE replay submission choke point: the ``replay_submit``
    fault site fires here (labels ``tenant``/``request_id``, exactly
    the serve_admit convention — chaos schedules shed replayed
    submissions through it), then the request goes to the live engine.
    Returns the ticket; injected faults raise like a shed."""
    from dbcsr_tpu_torch.resilience import faults as _faults

    rid = request_id or entry["request_id"]
    if _faults.active():
        _faults.maybe_inject("replay_submit", tenant=session.tenant,
                             request_id=rid)
    return engine.submit(
        session, op=entry.get("op", "multiply"),
        priority=entry.get("priority", 10),
        deadline_s=entry.get("deadline_s"),
        request_id=rid, **kwargs)


import atexit


@atexit.register
def _atexit_close() -> None:  # pragma: no cover - process teardown
    try:
        disable_sink()
    except Exception:
        pass


# env activation: DBCSR_TPU_TORCH_WORKLOAD=<path> at import records
# every terminal request (`serve/__init__.py` imports this module, so
# the knob works from a bare `import dbcsr_tpu_torch.serve`)
if _enabled and _env:
    try:
        enable_sink(_env)
    except (ValueError, OSError):
        pass

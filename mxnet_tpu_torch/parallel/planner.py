"""The sharding planner: one declarative plan for every parallel layout,
as the JAX package's ``parallel/planner.py``.

A :class:`ShardingPlan` is the named mesh's axes, an ordered list of
``(regex, spec)`` rules over parameter names (the first
``re.search`` match wins; a scalar is never partitioned; a parameter no
rule matches is replicated) and the plan-level fields: which axis plays
data, tensor, pipeline and sequence parallel, the ZeRO stage, the
pipeline stage overrides, the serving decode spec and the declared wire
precision.  A spec entry is ``None`` (the dimension whole), an axis name,
or a tuple of axis names; ``()`` is replicated.  The record
(:meth:`ShardingPlan.to_record`/``to_json``) is the JAX package's, key
for key, so a plan file written by either package loads in the other.

In the port a spec is a :class:`PartitionSpec` (a tuple, as ``jax``'s
``P``), which :func:`placements` turns into the ``torch.distributed``
placements of a ``DeviceMesh`` (``Shard(d)`` on the mesh dimension the
spec names at tensor dimension ``d``, ``Replicate()`` elsewhere);
:meth:`ShardingPlan.build_mesh` is the port's :class:`~.mesh.Mesh` over
the process group.  ``MXTPU_SHARDING_PLAN`` points the trainers at a
plan file.
"""
from __future__ import annotations

import hashlib
import json
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError

__all__ = ["ShardingPlan", "PartitionSpec", "placements",
           "megatron_rules", "plan_from_env", "resolve_plan_axis",
           "flat_rows", "resolve_shardings", "diff_records", "note_plan",
           "plans",
           "SCALAR", "WIRE_LEG_KINDS", "WIRE_DTYPES",
           "wire_dtype_itemsize"]

#: rule-index sentinel: the param is scalar/single-element and the
#: planner never partitions it
SCALAR = -1

_FORMAT = 1

#: wire-leg kinds a plan-level ``precision`` entry may declare (the JAX
#: package's wire taxonomy; the record keeps them so a plan file moves
#: between the packages)
WIRE_LEG_KINDS = ("dp_grad", "zero_scatter", "zero_gather",
                  "tp_act", "pp", "sp", "decode")

#: canonical wire dtype name -> itemsize, for the plan ``precision``
#: grammar (numpy's spelling, ``np.dtype(x).name``; the fp8 and bf16
#: entries are listed so validation needs no extension types)
WIRE_DTYPES = {
    "bool": 1, "int8": 1, "uint8": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int16": 2, "uint16": 2, "float16": 2, "bfloat16": 2,
    "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8,
}


def wire_dtype_itemsize(name: str) -> int:
    """Itemsize of one canonical wire dtype name (the ``precision``
    grammar).  Falls back to ``np.dtype`` for spellings like ``f4``
    so hand-written plan JSON is forgiving; raises ``MXNetError`` on
    names neither table knows."""
    name = str(name)
    if name in WIRE_DTYPES:
        return WIRE_DTYPES[name]
    try:
        dt = np.dtype(name)
    except TypeError:
        raise MXNetError(
            f"unknown wire dtype {name!r} (want one of "
            f"{sorted(WIRE_DTYPES)})")
    return int(dt.itemsize)


def _canon_spec(spec) -> tuple:
    """Canonical tuple form of a partition spec: entries are ``None``,
    an axis name, or a tuple of axis names.  Accepts a
    :class:`PartitionSpec`, tuple/list, ``None`` (replicated),
    or a single axis name."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    out = []
    for e in tuple(spec):
        if e is None or isinstance(e, str):
            out.append(e)
        elif isinstance(e, (tuple, list)) and e and \
                all(isinstance(a, str) for a in e):
            out.append(tuple(e))
        else:
            raise MXNetError(
                f"bad partition-spec entry {e!r} (want None, an axis "
                "name, or a tuple of axis names)")
    while out and out[-1] is None:
        out.pop()              # P('tp', None) == P('tp'): one form
    return tuple(out)


def _spec_axes(spec) -> tuple:
    """Every mesh axis a canonical spec mentions."""
    out = []
    for e in spec:
        if e is None:
            continue
        out.extend(e if isinstance(e, tuple) else (e,))
    return tuple(out)


def _spec_json(spec):
    """JSON form: tuples become lists (round-trips via _canon_spec)."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


class PartitionSpec(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: entry ``d``
    is ``None``, an axis name or a tuple of axis names for tensor
    dimension ``d``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec


def _partition_spec(spec):
    return PartitionSpec(*spec)


def placements(spec, mesh_axes):
    """The ``torch.distributed.tensor`` placements of ``spec`` on a mesh
    of ``mesh_axes`` (names in mesh order): ``Shard(d)`` on each mesh
    dimension the spec names at tensor dimension ``d``, ``Replicate()``
    on the others.  A tensor dimension split over several mesh axes
    takes them in the spec's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(_canon_spec(spec)):
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            if ax not in names:
                raise MXNetError(f"spec {tuple(spec)} names axis {ax!r}, "
                                 f"not one of {names}")
            out[names.index(ax)] = Shard(d)
    return out


def _axis_factor(spec, mesh_axes):
    """dim index -> (axis names, shard count) for the sharded dims."""
    out = {}
    for d, entry in enumerate(tuple(spec or ())):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for name in names:
            n *= int(mesh_axes.get(name, 1))
        out[d] = (names, n)
    return out


def _moves(src_spec, src_mesh, dst_spec, dst_mesh):
    """The collective moves a layout change needs, as op strings (the
    JAX package's ``elastic.reshard.plan``)."""
    src = _axis_factor(src_spec, src_mesh)
    dst = _axis_factor(dst_spec, dst_mesh)
    steps = []
    for d in sorted(set(src) | set(dst)):
        s, t = src.get(d), dst.get(d)
        if s == t and (s is None or
                       src_mesh.get(s[0][0]) == dst_mesh.get(s[0][0])):
            continue
        if s is not None:
            steps.append(f"all_gather(dim={d}, {'x'.join(s[0])}:{s[1]})")
        if t is not None:
            steps.append(f"slice(dim={d}, {'x'.join(t[0])}:{t[1]})")
    if not steps and dict(src_mesh) != dict(dst_mesh):
        steps.append("replicate(" + "x".join(
            f"{k}:{v}" for k, v in dst_mesh.items()) + ")")
    return steps


class ShardingPlan:
    """One declarative parallelism plan: named mesh axes + ordered
    regex partition rules + the plan-level stage/serving fields.

    Args:
      axes: ordered ``{axis_name: size}`` of the named mesh (e.g.
        ``{"dp": 4, "tp": 2}``).  The plan IS the mesh description;
        :meth:`build_mesh` makes (and memoizes) the mesh over the
        process group.
      rules: ordered ``[(regex, spec), ...]`` over param paths.  First
        ``re.search`` match wins; specs name only plan axes.
      dp_axis/tp_axis/pp_axis/sp_axis: which axis plays which role
        (consumers read these instead of hard-coding names:
        the trainer's batch axis, megatron rules' tensor axis,
        ``pipeline_apply``'s stage axis, ``ring_attention``'s
        sequence axis).
      zero_stage: the ZeRO stage this plan pins (``None`` defers to
        ``MXTPU_ZERO_STAGE``; 0/1/2 override the env — the plan is the
        single source of truth when present).
      stage_rules: ordered ``[(regex, stage_index), ...]`` pipeline
        stage assignment overrides; params matching none fall back to
        the layer-number layout (``planning._layer_stage``).
      decode: partition spec for the serving plane's KV pages /
        decode batch dim (leading entry shards the slot dim).  ``None``
        = single-chip decode (the pre-plan behavior).
      precision: declared per-leg-kind wire dtype,
        ``{leg_kind: dtype_name}`` over :data:`WIRE_LEG_KINDS` (e.g.
        ``{"dp_grad": "int8"}`` — "grad sync rides the wire
        quantized"): validated and recorded, as the JAX package's
        record has it.  ``None`` = nothing declared.
    """

    def __init__(self, axes: Dict[str, int],
                 rules: Sequence[Tuple[str, object]] = (),
                 *, dp_axis: str = "dp", tp_axis: str = "tp",
                 pp_axis: str = "pp", sp_axis: str = "sp",
                 zero_stage: Optional[int] = None,
                 stage_rules: Sequence[Tuple[str, int]] = (),
                 decode=None, precision: Optional[Dict[str, str]] = None):
        if not axes:
            raise MXNetError("a plan needs at least one mesh axis")
        self.axes = {}
        for k, v in dict(axes).items():
            k, v = str(k), int(v)
            if v < 1:
                raise MXNetError(f"mesh axis {k!r} has size {v}")
            self.axes[k] = v
        if dp_axis not in self.axes:
            raise MXNetError(
                f"dp_axis {dp_axis!r} is not a plan axis "
                f"{list(self.axes)}")
        self.dp_axis = str(dp_axis)
        self.tp_axis = str(tp_axis)
        self.pp_axis = str(pp_axis)
        self.sp_axis = str(sp_axis)
        if zero_stage is not None and int(zero_stage) not in (0, 1, 2):
            raise MXNetError(
                f"plan zero_stage must be 0, 1, or 2, got {zero_stage}")
        self.zero_stage = None if zero_stage is None else int(zero_stage)
        self.rules: List[Tuple[str, tuple]] = []
        self._compiled: List = []
        for n, entry in enumerate(rules):
            try:
                pattern, spec = entry
            except (TypeError, ValueError):
                raise MXNetError(
                    f"rule #{n} must be a (regex, spec) pair, got "
                    f"{entry!r}")
            pattern = str(pattern)
            try:
                rx = re.compile(pattern)
            except re.error as e:
                raise MXNetError(
                    f"rule #{n} regex {pattern!r} does not compile: {e}")
            spec = _canon_spec(spec)
            for ax in _spec_axes(spec):
                if ax not in self.axes:
                    raise MXNetError(
                        f"rule #{n} ({pattern!r} -> {spec}) names "
                        f"mesh axis {ax!r}, not one of "
                        f"{list(self.axes)}")
            self.rules.append((pattern, spec))
            self._compiled.append(rx)
        self.stage_rules: List[Tuple[str, int]] = []
        self._stage_compiled: List = []
        for n, (pattern, stage) in enumerate(stage_rules):
            pattern, stage = str(pattern), int(stage)
            if not 0 <= stage < self.n_stages:
                raise MXNetError(
                    f"stage rule #{n} assigns stage {stage}, plan has "
                    f"{self.n_stages} pipeline stage(s)")
            try:
                rx = re.compile(pattern)
            except re.error as e:
                raise MXNetError(
                    f"stage rule #{n} regex {pattern!r} does not "
                    f"compile: {e}")
            self.stage_rules.append((pattern, stage))
            self._stage_compiled.append(rx)
        self.decode = None if decode is None else _canon_spec(decode)
        if self.decode is not None:
            for ax in _spec_axes(self.decode):
                if ax not in self.axes:
                    raise MXNetError(
                        f"decode spec {self.decode} names mesh axis "
                        f"{ax!r}, not one of {list(self.axes)}")
        self.precision: Optional[Dict[str, str]] = None
        if precision is not None:
            if not isinstance(precision, dict):
                raise MXNetError(
                    f"plan precision must be a dict of "
                    f"leg_kind -> dtype name, got {precision!r}")
            canon = {}
            for leg, dt in precision.items():
                leg = str(leg)
                if leg not in WIRE_LEG_KINDS:
                    raise MXNetError(
                        f"precision names unknown wire leg {leg!r} "
                        f"(want one of {list(WIRE_LEG_KINDS)})")
                wire_dtype_itemsize(dt)    # validates; raises on junk
                canon[leg] = str(dt)
            self.precision = canon
        self._mesh = None

    # -- mesh -------------------------------------------------------------
    @property
    def n_devices(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    @property
    def n_stages(self) -> int:
        return int(self.axes.get(self.pp_axis, 1))

    def build_mesh(self, devices=None):
        """The plan's named mesh over the process group (memoized: every
        consumer of one plan sees one mesh, whose sub-groups every rank
        makes once)."""
        if self._mesh is None or devices is not None:
            from .mesh import make_mesh
            mesh = make_mesh(dict(self.axes), devices=devices)
            if devices is not None:
                return mesh
            self._mesh = mesh
        return self._mesh

    # -- resolution -------------------------------------------------------
    def match(self, name: str) -> Optional[int]:
        """Index of the first rule whose regex matches ``name`` (None
        = no rule — the param replicates silently)."""
        for i, rx in enumerate(self._compiled):
            if rx.search(name) is not None:
                return i
        return None

    def _entry_fan(self, entry) -> int:
        fan = 1
        for ax in ((entry,) if isinstance(entry, str)
                   else (entry or ())):
            fan *= int(self.axes.get(ax, 1))
        return fan

    def spec_for(self, name: str, shape) -> Tuple[tuple, Optional[int]]:
        """``(canonical spec, rule index)`` for one param path.
        Scalars/single-element tensors resolve replicated with index
        ``SCALAR``; unmatched params resolve replicated with index
        ``None``.  A matched rule whose sharded dim does NOT divide
        its axis fan-out DEMOTES to replication (an uneven shard is
        refused at placement — e.g. an odd vocab under a tp-sharded
        embed rule) — the rule index is kept so :meth:`coverage` can
        NAME the rule that failed to apply."""
        shape = tuple(int(d) for d in shape)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return (), SCALAR
        i = self.match(name)
        if i is None:
            return (), None
        spec = self.rules[i][1]
        if len(spec) > len(shape):
            raise MXNetError(
                f"rule #{i} ({self.rules[i][0]!r} -> {spec}) names "
                f"{len(spec)} dims but param {name!r} has shape "
                f"{shape}")
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            if shape[d] % self._entry_fan(entry):
                return (), i          # demoted: layout not honorable
        return spec, i

    def partition_spec(self, name: str, shape):
        """:class:`PartitionSpec` for one param, or ``None``
        when the plan replicates it (the ``param_sharding`` calling
        convention)."""
        spec, _i = self.spec_for(name, shape)
        return _partition_spec(spec) if spec else None

    def _spec_shards(self, spec) -> bool:
        return any(self.axes.get(ax, 1) > 1 for ax in _spec_axes(spec))

    def decode_shards(self) -> bool:
        """True when the serving decode spec actually shards on this
        mesh (some named axis has size > 1) — the Server's
        "activate the planned decode layout" gate."""
        return self.decode is not None and \
            self._spec_shards(self.decode)

    def decode_fanout(self) -> int:
        """Device fan-out of the serving decode spec's LEADING entry —
        the slot dim: every bucket's slot count must divide this
        (``serving.Server`` validates at construction AND on
        ``resize_slots``).  1 when no decode spec is set."""
        if not self.decode:
            return 1
        lead = self.decode[0]
        fan = 1
        for ax in ((lead,) if isinstance(lead, str) else (lead or ())):
            fan *= int(self.axes.get(ax, 1))
        return fan

    def param_rule(self) -> Optional[Callable]:
        """A ``(name, shape) -> PartitionSpec | None`` rule for
        ``DataParallelTrainer(param_sharding=...)``.  ``None`` when no
        rule can actually shard anything on this mesh (every spec
        empty, or every named axis has size 1) — the trainer then
        treats the plan as pure data-parallel, which keeps ZeRO
        eligibility exactly as the layout implies."""
        if not any(self._spec_shards(spec) for _p, spec in self.rules):
            return None
        return self.partition_spec

    def resolve(self, named_shapes, dtype_bytes: int = 4):
        """Resolve every ``(name, shape)``: ordered ``{name: row}``
        with ``spec``, ``rule`` (index | SCALAR | None), ``shards``
        (device fan-out of the spec on this mesh), ``nbytes`` (global)
        and ``per_device_bytes``."""
        out = {}
        for name, shape in named_shapes:
            shape = tuple(int(d) for d in shape)
            spec, idx = self.spec_for(name, shape)
            shards = 1
            for ax in _spec_axes(spec):
                shards *= self.axes[ax]
            elems = 1
            for d in shape:
                elems *= d
            nbytes = elems * int(dtype_bytes)
            out[name] = {
                "shape": shape, "spec": spec, "rule": idx,
                "shards": shards, "nbytes": nbytes,
                "per_device_bytes": -(-nbytes // shards),
                # the rule WANTED a sharding the shape cannot honor
                # (non-divisible dim) and resolution replicated instead
                "demoted": bool(idx is not None and idx >= 0 and
                                not spec and self.rules[idx][1]),
            }
        return out

    def stage_of(self, name: str, num_layers: int) -> int:
        """Pipeline stage for one param: explicit ``stage_rules``
        first, then the layer-number layout (decoder layer i goes to
        stage ``i // ceil(L/S)``; embeddings first, head/final norm
        last — ``planning._layer_stage``)."""
        for rx, (_p, stage) in zip(self._stage_compiled,
                                   self.stage_rules):
            if rx.search(name) is not None:
                return stage
        from .planning import _layer_stage
        return _layer_stage(name, num_layers, self.n_stages)

    # -- coverage audit ---------------------------------------------------
    def coverage(self, named_shapes, dtype_bytes: int = 4,
                 big_bytes: int = 64 << 20) -> dict:
        """Audit the plan against a param tree.  Returns::

            {"uncovered":      [(name, shape, nbytes), ...],
             "shadowed":       [(rule_idx, pattern, shadowing_idx), ...],
             "replicated_big": [(name, nbytes, rule_idx), ...],
             "demoted":        [(name, shape, rule_idx), ...]}

        * ``uncovered`` — a non-scalar param matched by NO rule
          (silent replication).  Only audited when the plan HAS rules:
          a rule-free plan is the deliberate pure-DP idiom, not a
          coverage gap;
        * ``demoted`` — a matched rule's sharding the shape cannot
          honor (non-divisible dim): the param replicated instead of
          crashing placement, and the rule is named;
        * ``shadowed`` — a rule that some param's name matches, yet an
          EARLIER rule claims every such param: the rule is unreachable
          dead weight (usually an ordering bug);
        * ``replicated_big`` — a tensor of at least ``big_bytes`` the
          resolved plan fully replicates on a >1-device mesh, with the
          responsible rule attributed (``None`` = no rule matched) —
          caught at the rule level.
        """
        named_shapes = [(n, tuple(int(d) for d in s))
                        for n, s in named_shapes]
        res = self.resolve(named_shapes, dtype_bytes=dtype_bytes)
        uncovered = [(n, r["shape"], r["nbytes"])
                     for n, r in res.items()
                     if r["rule"] is None] if self.rules else []
        shadowed = []
        for j, (pattern, _spec) in enumerate(self.rules):
            rx = self._compiled[j]
            # scalar params resolve SCALAR before any regex runs, so
            # they can neither be claimed by a rule nor witness one
            would = [n for n, _s in named_shapes
                     if rx.search(n) is not None and
                     res[n]["rule"] != SCALAR]
            if not would:
                continue            # matches nothing here: just unused
            if all(res[n]["rule"] < j for n in would):
                first = min(res[n]["rule"] for n in would)
                shadowed.append((j, pattern, first))
        replicated_big = []
        if self.n_devices > 1:
            for n, r in res.items():
                if r["rule"] == SCALAR:
                    continue
                if r["nbytes"] >= big_bytes and r["shards"] == 1:
                    replicated_big.append((n, r["nbytes"], r["rule"]))
        demoted = [(n, r["shape"], r["rule"])
                   for n, r in res.items() if r["demoted"]]
        return {"uncovered": uncovered, "shadowed": shadowed,
                "replicated_big": replicated_big, "demoted": demoted}

    # -- canonical serialization (manifest pin) ---------------------------
    def to_record(self) -> dict:
        """Canonical JSON-able form — THE manifest field and the
        struct-hash input.  Stable across processes (no live objects,
        sorted-key JSON)."""
        rec = {
            "format": _FORMAT,
            "axes": [[k, v] for k, v in self.axes.items()],
            "dp_axis": self.dp_axis, "tp_axis": self.tp_axis,
            "pp_axis": self.pp_axis, "sp_axis": self.sp_axis,
            "zero_stage": self.zero_stage,
            "rules": [[p, _spec_json(s)] for p, s in self.rules],
            "stage_rules": [[p, s] for p, s in self.stage_rules],
            "decode": None if self.decode is None
            else _spec_json(self.decode),
        }
        # only-when-set, so every pre-precision plan keeps its exact
        # struct_hash (manifests/warm-starts pin the hash; an absent
        # declaration must not reshuffle them)
        if self.precision is not None:
            rec["precision"] = {k: self.precision[k]
                                for k in sorted(self.precision)}
        return rec

    def to_json(self) -> str:
        return json.dumps(self.to_record(), indent=1, sort_keys=True)

    def struct_hash(self, ignore_sizes: bool = False) -> str:
        """16-hex sha256 over the canonical record — what the persist
        identities and warm-start/checkpoint manifests pin.
        ``ignore_sizes`` zeroes the axis sizes first (the reshard-path
        identity: rules/roles/stage/decode must agree, mesh sizes
        legitimately differ — the same convention as
        ``diff_records(ignore_sizes=True)``)."""
        rec = self.to_record()
        if ignore_sizes:
            rec["axes"] = [[k, 1] for k, _v in rec["axes"]]
        return hashlib.sha256(
            json.dumps(rec, sort_keys=True).encode()).hexdigest()[:16]

    @classmethod
    def from_record(cls, rec) -> "ShardingPlan":
        if not isinstance(rec, dict):
            raise MXNetError(f"malformed plan record: {type(rec)}")
        if rec.get("format") != _FORMAT:
            raise MXNetError(
                f"unsupported plan format {rec.get('format')!r} "
                f"(this build reads format {_FORMAT})")
        try:
            axes = {str(k): int(v) for k, v in rec["axes"]}
            rules = [(p, s) for p, s in rec.get("rules") or ()]
            stage_rules = [(p, int(s))
                           for p, s in rec.get("stage_rules") or ()]
        except (KeyError, TypeError, ValueError) as e:
            raise MXNetError(f"malformed plan record: {e!r}")
        return cls(axes, rules,
                   dp_axis=rec.get("dp_axis", "dp"),
                   tp_axis=rec.get("tp_axis", "tp"),
                   pp_axis=rec.get("pp_axis", "pp"),
                   sp_axis=rec.get("sp_axis", "sp"),
                   zero_stage=rec.get("zero_stage"),
                   stage_rules=stage_rules,
                   decode=rec.get("decode"),
                   # fail-open: a precision-free legacy record loads
                   # with nothing declared (same contract as zero_stage)
                   precision=rec.get("precision"))

    @classmethod
    def from_json(cls, text: str) -> "ShardingPlan":
        try:
            rec = json.loads(text)
        except ValueError as e:
            raise MXNetError(f"malformed plan JSON: {e}")
        return cls.from_record(rec)

    @classmethod
    def load(cls, path: str) -> "ShardingPlan":
        try:
            with open(path) as f:
                text = f.read()
        except OSError as e:
            raise MXNetError(f"cannot read plan {path!r}: {e}")
        return cls.from_json(text)

    def save(self, path: str) -> str:
        import os
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)
        return path

    # -- plan-to-plan -----------------------------------------------------
    def diff(self, other: "ShardingPlan", named_shapes,
             dtype_bytes: int = 4) -> List[dict]:
        """Per-param reshard report ``self -> other``: what a
        plan-to-plan redistribution would move.  Rows only for params
        whose layout actually changes: ``{name, from_spec, to_spec,
        moves, nbytes}`` (``moves``: the collectives of the change)."""
        a = self.resolve(named_shapes, dtype_bytes=dtype_bytes)
        b = other.resolve(named_shapes, dtype_bytes=dtype_bytes)
        out = []
        for name, ra in a.items():
            rb = b[name]
            moves = _moves(ra["spec"], dict(self.axes), rb["spec"],
                           dict(other.axes))
            if not moves and ra["spec"] == rb["spec"] and \
                    dict(self.axes) == dict(other.axes):
                continue
            out.append({"name": name, "from_spec": ra["spec"],
                        "to_spec": rb["spec"], "moves": moves,
                        "nbytes": ra["nbytes"]})
        return out

    def __eq__(self, other):
        return isinstance(other, ShardingPlan) and \
            self.to_record() == other.to_record()

    def __hash__(self):
        return hash(self.struct_hash())

    def __repr__(self):
        prec = f", precision={self.precision}" if self.precision else ""
        return (f"ShardingPlan(axes={self.axes}, "
                f"{len(self.rules)} rule(s), dp={self.dp_axis!r}, "
                f"zero_stage={self.zero_stage}, "
                f"decode={self.decode}{prec})")


# -- shipped default rule sets ----------------------------------------------

def megatron_rules(tp_axis: str = "tp") -> List[Tuple[str, tuple]]:
    """The shipped megatron row/column rule set for the llama and BERT
    block families.

    Column-parallel (output dim sharded; the next op consumes the
    shard locally): llama q/k/v + gate/up, BERT query/key/value + ffn1
    (weights are ``(out, in)``, so dim 0 shards) and their biases;
    row-parallel (input dim sharded; XLA inserts the psum): llama
    o/down, BERT out/ffn2; vocab-sharded: embedding + untied LM head;
    norms/everything else explicitly replicated by the trailing
    catch-all (full coverage)."""
    col = (tp_axis, None)
    row = (None, tp_axis)
    return [
        # llama family (models/llama.py param paths)
        (r"(attn_[qkv]|mlp_(gate|up))_weight$", col),
        (r"(attn_o|mlp_down)_weight$", row),
        # BERT family (models/bert.py param paths)
        (r"(query|key|value|ffn1)_weight$", col),
        (r"(query|key|value|ffn1)_bias$", (tp_axis,)),
        (r"(out|ffn2)_weight$", row),
        # vocab-sharded embedding + untied head (both families)
        (r"(embed|head)_weight$", col),
        # everything else (norms, biases, position embeddings):
        # explicitly replicated, so every param is covered by SOME rule
        (r".", ()),
    ]


# -- env entry point --------------------------------------------------------

def plan_from_env() -> Optional[ShardingPlan]:
    """The plan ``MXTPU_SHARDING_PLAN`` points at (a plan-JSON path),
    or ``None`` when unset.  A malformed file raises loudly — a typo'd
    plan silently training replicated is the failure mode the planner
    exists to kill."""
    from .. import envs
    path = str(envs.get("MXTPU_SHARDING_PLAN") or "").strip()
    if not path:
        return None
    return ShardingPlan.load(path)


# -- THE single resolution / layout definitions -----------------------------

def resolve_plan_axis(plan, mesh, axis: str, role: str):
    """Plan-aware ``(mesh, axis)`` resolution shared by the pipeline
    and ring-attention entry points: a plan supplies BOTH the named
    mesh and the role axis (``role`` is the plan attribute name, e.g.
    ``"pp_axis"``/``"sp_axis"``), so callers stop hard-coding axis
    strings.  ``plan=None`` passes the caller's args through."""
    if plan is None:
        return mesh, axis
    if not isinstance(plan, ShardingPlan):
        raise MXNetError(
            f"plan= must be a parallel.ShardingPlan, got "
            f"{type(plan).__name__}")
    if mesh is None:
        mesh = plan.build_mesh()
    return mesh, getattr(plan, role)


def resolve_shardings(mesh, named_shapes, rule):
    """``[(name, shape)] -> tuple`` of each parameter's placements on
    ``mesh`` under ``rule`` (the ``(name, shape) -> PartitionSpec |
    None`` convention; a ``None`` rule replicates everything): the one
    answer to "what layout does this parameter get"."""
    out = []
    for name, shape in named_shapes:
        spec = rule(name, shape) if rule is not None else None
        out.append(tuple(placements(spec or (), mesh.shape)))
    return tuple(out)


def flat_rows(shape, n_dp: int) -> Tuple[int, int, int]:
    """``(size, padded, chunk)`` of one param's flat ZeRO partition:
    flat length, padded to a multiple of ``n_dp``, per-member slice."""
    size = 1
    for d in shape:
        size *= int(d)
    padded = size + ((-size) % int(n_dp))
    return size, padded, padded // int(n_dp)


# -- live-plan registry -----------------------------------------------------

_reg_lock = threading.Lock()
_plans: Dict[str, dict] = {}


def note_plan(owner: str, plan: ShardingPlan, named_shapes,
              dtype_bytes: int = 4) -> None:
    """Register a live consumer's plan + param tree for the coverage
    audit.  Never raises (telemetry-grade)."""
    try:
        with _reg_lock:
            _plans[str(owner)] = {
                "plan": plan,
                "named_shapes": [(str(n), tuple(int(d) for d in s))
                                 for n, s in named_shapes],
                "dtype_bytes": int(dtype_bytes),
            }
    except Exception:
        pass


def plans() -> Dict[str, dict]:
    """Registered live plans (copies)."""
    with _reg_lock:
        return {k: dict(v) for k, v in _plans.items()}


def _reset():
    """Test hook."""
    with _reg_lock:
        _plans.clear()


# -- manifest comparison ----------------------------------------------------

def _rule_str(entry) -> str:
    p, s = entry[0], entry[1]
    return f"{p!r} -> {tuple(s) if isinstance(s, list) else s}"


def diff_records(a, b, ignore_sizes: bool = False) -> Optional[str]:
    """Compare two canonical plan records (dicts from
    :meth:`ShardingPlan.to_record`, or ``None``).  Returns ``None``
    when equivalent, else a one-line reason NAMING the diverging rule
    or field — the fail-open warm-start/manifest reject message.
    ``ignore_sizes`` compares axis NAMES but not sizes (the reshard
    warm-start path, where a mesh-size change is legitimate)."""
    if a is None and b is None:
        return None
    if (a is None) != (b is None):
        return ("one side has a sharding plan and the other does not "
                f"(manifest: {'set' if a else 'unset'}, current: "
                f"{'set' if b else 'unset'})")
    ra = [tuple(r) for r in a.get("rules") or ()]
    rb = [tuple(r) for r in b.get("rules") or ()]
    for i, (ea, eb) in enumerate(zip(ra, rb)):
        if list(ea[1] or []) != list(eb[1] or []) or ea[0] != eb[0]:
            return (f"rule #{i} diverges: manifest {_rule_str(ea)} vs "
                    f"current {_rule_str(eb)}")
    if len(ra) != len(rb):
        longer, which = (ra, "manifest") if len(ra) > len(rb) \
            else (rb, "current")
        i = min(len(ra), len(rb))
        return (f"rule #{i} exists only in the {which} plan: "
                f"{_rule_str(longer[i])}")
    axes_a = [[k, 1 if ignore_sizes else v]
              for k, v in a.get("axes") or ()]
    axes_b = [[k, 1 if ignore_sizes else v]
              for k, v in b.get("axes") or ()]
    if axes_a != axes_b:
        return (f"mesh axes diverge: manifest {a.get('axes')} vs "
                f"current {b.get('axes')}")
    for field in ("dp_axis", "tp_axis", "pp_axis", "sp_axis",
                  "zero_stage", "stage_rules", "decode", "precision"):
        if a.get(field) != b.get(field):
            return (f"plan field {field!r} diverges: manifest "
                    f"{a.get(field)!r} vs current {b.get(field)!r}")
    return None

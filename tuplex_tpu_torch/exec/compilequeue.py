"""The compile plane: one CUDA graph per (stage, input shapes) (counterpart
of `tuplex_tpu/exec/compilequeue.py`).

The reference runs each stage as one compiled XLA executable per (stage
key, batch spec), kept in a content-addressed store. The port's fused
stage function (plan/physical.py `build_device_fn`) issues its torch ops
and kernel launches eagerly, each at a cost in host time, so here the
executable is a CUDA graph: the first partition of a key is captured, and
later partitions, and later jobs in the same process, replay it.

`run_stage` is the one entry (exec/local.py `_dispatch_partition`):

  * `fingerprint_stage` gives the key: the operators (kind, schema,
    parameters, UDF code, constants, defaults, closure values and every
    global the UDF reads), the fused fold, the compaction plan, the input
    schema, the flags `build_device_fn` takes, the name, shape and dtype
    of every staged tensor, and the device. Operator ids enter relative
    to the stage's first, and a replay under other ids shifts the ids
    packed into '#err'. A value that cannot be hashed faithfully keys the
    stage by its own identity (no reuse across jobs), counted in
    `key_fallbacks` by reason.
  * A key's first partition runs the function eagerly on the device's
    side stream (the warm-up, whose outputs serve that partition) under a
    watch of its torch calls (`_Guard`), then captures it on that stream
    into a `torch.cuda.CUDAGraph` whose memory comes from a pool shared by
    the device's graphs (they replay one after another on one stream, so
    a capture reuses what earlier captures freed). A stage function
    that waits on the card (`.item()`, `bool()` of a tensor, a mask
    index, ...) or copies host data to it while it runs cannot be
    captured: it runs eagerly, counted in `graph_declined` by reason.
  * A replay copies the partition's padded host arrays (`C.host_arrays`,
    the same arrays the key was computed from) or its handed-off view's
    tensors into the graph's static inputs, replays, and returns clones
    of the static outputs: the next replay overwrites them while earlier
    partitions are still in flight (exec/local.py `_WINDOW`) or handed
    off as views.
  * Kernel launches inside a graph are not Python calls: the counters of
    the kernel wrappers (`_COUNTERS`) move by what the capture would have
    added, recorded at capture and added at each replay.

On the CPU there are no CUDA graphs. The stand-in keeps the closure and
the static buffers: its capture allocates the static outputs, its replay
runs the closure on the static inputs and copies the results into the
static outputs, which it clones out. So CPU runs keep the same
static-buffer discipline the card relies on. The warm-up's watch runs on
the CPU too and declines what the card's capture would for a wait, a
host index or a factory that puts host data on the device; a `.to()` of
host data copies nothing on the CPU and is seen on the card only.

The store is bounded by the bytes its graphs hold on the card, their
pools' included (`GraphStore`, least recently used first); a pool goes
back to torch's allocator with its last graph.
`eager()` runs the old per-partition path, for comparisons in the smoke and
the tests; it is no user option.

Not ported, with the reason: the reference's on-disk AOT store (a CUDA
graph cannot be serialized), its compile pool and background lane
(capture must run on the dispatching stream), and its watchdog and
subprocess isolation. The plane never forks and starts no process.
"""

from __future__ import annotations

import ast
import contextlib
import hashlib
import itertools
import os
import re
import sys
import sysconfig
import time
import types
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..core import typesys as T
from ..ops import join_cuda, nfa_cuda, regex, segfold_cuda
from ..runtime import columns as C
from ..runtime.xferstats import copy_to_device

# -- counters ---------------------------------------------------------------
# stage_compiles: graph captures (0 on a warm second run of a job)
# compile_s: seconds inside the captures (the warm-up serves a partition
#   and is dispatch time)
# dedup_hits: a stage finding a graph another stage object captured (a
#   later job, an isomorphic stage); once per (stage, key)
# graph_replays: partitions dispatched by a replay
# graph_declined: partitions run eagerly because their key's stage function
#   cannot be captured, by reason
# key_fallbacks: stages keyed by their identity, by the unhashable value
# *_dispatches / *_dispatch_s: partitions and host seconds of dispatches
#   that captured (warm-up and capture), replayed, or ran eagerly
# pool_bytes: bytes the captures added to the graph pools
STATS: dict[str, Any] = {}


def clear() -> None:
    """Reset `STATS` and empty the store (tests; a fresh process)."""
    STATS.clear()
    STATS.update({
        "stage_compiles": 0, "compile_s": 0.0, "dedup_hits": 0,
        "graph_replays": 0, "graph_declined": {}, "key_fallbacks": {},
        "capture_dispatches": 0, "capture_dispatch_s": 0.0,
        "replay_dispatch_s": 0.0, "eager_dispatches": 0,
        "eager_dispatch_s": 0.0, "pool_bytes": 0})
    STORE.clear()
    _DECLINED.clear()


def snapshot() -> dict:
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in STATS.items()}


def delta(snap: dict) -> dict:
    """The counts added since `snap`, the dicts by key."""
    out: dict = {}
    for k, v in STATS.items():
        if isinstance(v, dict):
            out[k] = {r: n - snap[k].get(r, 0) for r, n in v.items()
                      if n != snap[k].get(r, 0)}
        else:
            out[k] = v - snap[k]
    return out


def stage_metrics(d: dict) -> dict:
    """A `delta` as a stage's flat metrics: `graph_declined_<reason>`,
    `key_fallback_<reason>`."""
    m = {k: v for k, v in d.items() if not isinstance(v, dict)}
    m.pop("pool_bytes", None)
    m.update({f"graph_declined_{r}": n
              for r, n in d["graph_declined"].items()})
    m.update({f"key_fallback_{r}": n for r, n in d["key_fallbacks"].items()})
    return m


# the kernel wrappers' launch counters (module, attribute)
_COUNTERS = ((nfa_cuda, "launches"), (nfa_cuda, "start_launches"),
             (regex, "calls"), (join_cuda, "launches"),
             (segfold_cuda, "launches"))


def _read_counts() -> tuple:
    return tuple(getattr(m, a) for m, a in _COUNTERS)


def _set_counts(vals) -> None:
    for (m, a), v in zip(_COUNTERS, vals):
        setattr(m, a, v)


def _add_counts(deltas) -> None:
    _set_counts(v + d for v, d in zip(_read_counts(), deltas))


_EAGER = 0


@contextlib.contextmanager
def eager():
    """Within it, stages dispatch as before the plane: staged, then the
    stage function run eagerly for every partition. For comparisons."""
    global _EAGER
    _EAGER += 1
    try:
        yield
    finally:
        _EAGER -= 1


# ---------------------------------------------------------------------------
# the content address
# ---------------------------------------------------------------------------

class _Unhashable(Exception):
    pass


_LIB_DIRS = tuple(sorted({os.path.realpath(p) for p in (
    sysconfig.get_paths()[k] for k in ("stdlib", "platstdlib", "purelib",
                                       "platlib")) if p}))
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
_LIB_MEMO: dict = {}


def _library_module(name: Optional[str]) -> bool:
    """Whether module `name` is library code (a module built into the
    interpreter, or a file of the standard library, site-packages or this
    package): its functions are keyed by name, user code by content. A
    module with no file of its own, as `__main__` is in a REPL, a notebook
    or `python -c`, is user code."""
    if name is None:
        return False
    hit = _LIB_MEMO.get(name)
    if hit is None:
        f = getattr(sys.modules.get(name), "__file__", None)
        if f is None:
            hit = name in sys.builtin_module_names
        else:
            f = os.path.realpath(f)
            hit = f.startswith(_PKG_DIR + os.sep) or any(
                f.startswith(d + os.sep) for d in _LIB_DIRS)
        _LIB_MEMO[name] = hit
    return hit


def _code_names(code: types.CodeType) -> set:
    names = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names |= _code_names(c)
    return names


class _Hasher:
    """Feeds Python values into a hash, faithfully or not at all: a value
    it cannot key raises _Unhashable."""

    def __init__(self):
        self.h = hashlib.blake2b(digest_size=20)
        self._stack: set = set()

    def put(self, s: str) -> None:
        self.h.update(s.encode("utf-8", "surrogatepass"))
        self.h.update(b"\x00")

    def code(self, co: types.CodeType) -> None:
        self.put(f"code:{co.co_argcount}:{co.co_kwonlyargcount}:"
                 f"{co.co_flags}")
        self.h.update(co.co_code)
        for names in (co.co_names, co.co_varnames, co.co_freevars,
                      co.co_cellvars):
            self.put(repr(names))
        self.put(f"consts{len(co.co_consts)}")
        for c in co.co_consts:
            if isinstance(c, types.CodeType):
                self.code(c)
            else:
                self.value(c)

    def module_attrs(self, mod, names) -> None:
        """A user module's attributes the code reads by name."""
        self.put(f"module:{mod.__name__}")
        if _library_module(mod.__name__):
            return
        for n in sorted(names):
            if n in vars(mod):
                self.put(n)
                self.value(vars(mod)[n])

    def globals_(self, globs: dict, names) -> None:
        for n in sorted(globs):
            self.put(f"g:{n}")
            v = globs[n]
            if isinstance(v, types.ModuleType):
                self.module_attrs(v, names)
            else:
                self.value(v)

    def function(self, f: types.FunctionType) -> None:
        if _library_module(f.__module__):
            self.put(f"fn:{f.__module__}.{f.__qualname__}")
            return
        if id(f) in self._stack:
            self.put(f"cycle:{f.__qualname__}")
            return
        if len(self._stack) >= 8:
            raise _Unhashable("deep_helpers")
        from ..utils.reflection import capture_globals

        self._stack.add(id(f))
        try:
            self.put("userfn")
            self.code(f.__code__)
            self.value(f.__defaults__)
            self.value(f.__kwdefaults__)
            self.globals_(capture_globals(f), _code_names(f.__code__))
        finally:
            self._stack.discard(id(f))

    def value(self, v) -> None:
        t = type(v)
        if v is None or t in (bool, int, float, complex, str, bytes):
            self.put(f"{t.__name__}:{v!r}")
        elif isinstance(v, T.Type):
            self.put(f"type:{v.name}")
        elif t in (tuple, list):
            self.put(f"{t.__name__}{len(v)}")
            for x in v:
                self.value(x)
        elif t in (set, frozenset, dict):
            items = v.items() if t is dict else ((x, None) for x in v)
            subs = []
            for k, x in items:
                sub = _Hasher()
                sub._stack = self._stack
                sub.value(k)
                sub.value(x)
                subs.append(sub.h.hexdigest())
            self.put(f"{t.__name__}:{','.join(sorted(subs))}")
        elif isinstance(v, ast.AST):
            self.put(ast.dump(v))
        elif isinstance(v, types.ModuleType):
            self.put(f"module:{v.__name__}")
        elif isinstance(v, types.FunctionType):
            self.function(v)
        elif isinstance(v, (types.BuiltinFunctionType,
                            types.MethodDescriptorType,
                            types.WrapperDescriptorType,
                            types.ClassMethodDescriptorType)):
            owner = getattr(v, "__self__", None)
            self.put(f"builtin:{getattr(v, '__module__', None)}."
                     f"{getattr(v, '__qualname__', v.__name__)}")
            if owner is not None and not isinstance(owner, (types.ModuleType,
                                                            type)):
                self.value(owner)
        elif isinstance(v, type):
            self.put(f"class:{v.__module__}.{v.__qualname__}")
        elif isinstance(v, re.Pattern):
            self.put(f"re:{v.flags}")
            self.value(v.pattern)
        elif isinstance(v, np.ndarray) and v.dtype != object and \
                v.nbytes <= 1 << 20:
            self.put(f"ndarray:{v.dtype.str}:{v.shape}")
            self.h.update(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, np.generic):
            self.put(f"np:{v.dtype.str}:{v!r}")
        else:
            raise _Unhashable(t.__name__)


_OP_SKIP = {"parents", "id", "udf"}


def _stage_digest(stage) -> str:
    """The content of a stage's operators and fused fold (memoized on the
    stage object), or its identity where a value cannot be keyed."""
    memo = stage.__dict__.get("_cq_digest")
    if memo is not None:
        return memo
    try:
        h = _Hasher()
        base, rel = _op_base(stage), _ids_in_range(stage)
        for op in stage.ops:
            h.put(f"op:{type(op).__qualname__}:"
                  f"{op.id - base if rel else op.id}:{op.schema().name}")
            for k in sorted(vars(op)):
                if k in _OP_SKIP or k.startswith("_"):
                    continue
                h.put(k)
                h.value(vars(op)[k])
            udf = getattr(op, "udf", None)
            if udf is not None:
                h.put(f"udf:{udf.source}")
                h.put(ast.dump(udf.tree))
                f = udf.func
                names = set()
                if isinstance(f, types.FunctionType):
                    h.code(f.__code__)
                    h.value(f.__defaults__)
                    h.value(f.__kwdefaults__)
                    names = _code_names(f.__code__)
                h.globals_(udf.globals, names)
        spec = stage.fold_spec
        if spec is not None:
            h.put(f"fold:{type(spec).__qualname__}")
            for k in sorted(vars(spec)):
                h.put(k)
                if k == "globals":
                    h.globals_(spec.globals, set().union(*(
                        {n.id for n in ast.walk(e) if isinstance(n, ast.Name)}
                        | {n.attr for n in ast.walk(e)
                           if isinstance(n, ast.Attribute)}
                        for e in spec.exprs)))
                else:
                    h.value(vars(spec)[k])
        memo = "c:" + h.h.hexdigest()
    except _Unhashable as e:
        reason = str(e)
        STATS["key_fallbacks"][reason] = \
            STATS["key_fallbacks"].get(reason, 0) + 1
        memo = f"identity:{_token(stage)}"
    stage._cq_digest = memo
    return memo


_TOKENS = itertools.count(1)


def _token(stage) -> int:
    """A number of the stage object's own, never reused (an `id()` can be,
    after the object is gone)."""
    tok = stage.__dict__.get("_cq_token")
    if tok is None:
        tok = stage._cq_token = next(_TOKENS)
    return tok


def _ids_in_range(stage) -> bool:
    """Whether every operator id of the stage packs into '#err' (core/errors
    `pack_device_code`): then ids key relative to the first one."""
    from ..core.errors import _OP_ID_LIMIT

    return all(0 < op.id < _OP_ID_LIMIT for op in stage.ops)


def _op_base(stage) -> int:
    return min((op.id for op in stage.ops), default=0)


def fingerprint_stage(stage, arrays: dict, flags: dict) -> str:
    """The content address of `stage`'s function over staged tensors with
    the names, shapes and dtypes of `arrays` (a device view's tensors, or
    a host partition's `C.host_arrays`, which key alike), built with
    `flags` (`build_device_fn`'s input schema, compaction, fold, general,
    str_cols, and the device)."""
    from ..plan.physical import _compaction_plan

    h = hashlib.blake2b(digest_size=20)
    h.update(_stage_digest(stage).encode())
    for k in sorted(flags):
        h.update(f"|{k}={flags[k]!r}".encode())
    if flags.get("compaction"):
        # where the stage compacts, and to what bucket, comes from the
        # operators' samples
        plan = stage.__dict__.get("_cq_plan")
        if plan is None:
            base = _op_base(stage)
            plan = stage._cq_plan = repr(sorted(
                (i - base, f) for i, f in _compaction_plan(stage.ops).items()))
        h.update(plan.encode())
    for k in sorted(arrays):
        a = arrays[k]
        dtype = str(a.dtype).removeprefix("torch.")   # numpy's names
        h.update(f"|{k}:{tuple(a.shape)}:{dtype}".encode())
    return h.hexdigest()


def _flags(stage, part, device, compaction: bool, fold: bool) -> dict:
    # what the closure decides from stage state enters the key: the fold
    # runs only while no earlier call found it outside the compiled subset
    return {"schema": part.schema.name, "compaction": bool(compaction),
            "fold": bool(fold and stage.fold_spec is not None
                         and not stage.fold_failed),
            "general": False, "str_cols": (), "device": str(device)}


# ---------------------------------------------------------------------------
# watching a stage function's torch calls
# ---------------------------------------------------------------------------

class _Decline(Exception):
    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason, self.detail = reason, detail


# calls that wait on the device or read its values on the host
_SYNCS = frozenset({
    "item", "__bool__", "__int__", "__float__", "__index__", "__complex__",
    "tolist", "numpy", "__array__", "nonzero", "argwhere", "masked_select",
    "unique", "unique_consecutive", "bincount", "equal", "allclose",
    "is_nonzero", "__repr__", "__format__"})
# tensors made from host data: the argument that holds it
_FACTORIES = {"tensor": 0, "as_tensor": 0, "asarray": 0, "new_tensor": 1}
_MOVES = frozenset({"to", "cuda", "cpu", "copy_", "type_as"})


def _waits(name: str, args, kwargs) -> bool:
    """Whether a torch call waits on the device: it reads a device value
    on the host, or its output's size depends on the values."""
    if name in _SYNCS:
        return True
    if name == "where":                  # where(cond) is nonzero(cond)
        return len(args) + len(kwargs) == 1
    if name == "repeat_interleave" and "output_size" not in kwargs:
        reps = args[1] if len(args) > 1 else kwargs.get(
            "repeats", args[0] if args else None)
        return isinstance(reps, torch.Tensor)
    return False


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _index_hazard(idx) -> Optional[tuple]:
    items = idx if isinstance(idx, tuple) else (idx,)
    for it in items:
        if isinstance(it, torch.Tensor) and it.dtype == torch.bool:
            return ("host_sync", "a boolean mask index")
        if isinstance(it, (list, np.ndarray)):
            return ("h2d_copy", "a host index")
    return None


def _move_hazard(name: str, args, out) -> Optional[tuple]:
    """A copy between the host and the device: host data into a device
    tensor, or device data back to the host (which waits)."""
    src = {t.device.type for t in _tensors(args, [])}
    dst = {t.device.type for t in _tensors(out, [])}
    if len(src | dst) < 2:
        return None
    return ("h2d_copy", name) if "cpu" in src and dst - {"cpu"} \
        else ("host_sync", name)


class _Guard(TorchFunctionMode):
    """Watches the torch calls of a stage function run on `device`. It
    notes the first call that waits on the device or (with `copies`)
    copies host data to it (`reason`), and in `strict` mode raises
    _Decline there. With `pin`
    it keeps every tensor the calls read that they did not make (constant
    tables, static inputs): a graph reads them by address at each
    replay."""

    def __init__(self, device, strict: bool = False, pin: bool = False,
                 copies: bool = True):
        super().__init__()
        self.device, self.strict, self.copies = device, strict, copies
        self.reason: Optional[tuple] = None
        self.pins: Optional[dict] = {} if pin else None
        self._made: set = set()

    def _note(self, why) -> None:
        if why is None or (why[0] == "h2d_copy" and not self.copies):
            return
        if self.reason is None:
            self.reason = why
        if self.strict:
            raise _Decline(*why)

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if _waits(name, args, kwargs):
            self._note(("host_sync", name))
        elif name in ("__getitem__", "__setitem__") and len(args) > 1:
            self._note(_index_hazard(args[1]))
        if self.pins is not None:
            for t in _tensors((args, kwargs), []):
                p = t.untyped_storage().data_ptr()
                if p not in self._made:
                    self.pins.setdefault(p, t)
        out = func(*args, **kwargs)
        if name in _FACTORIES:
            # host data put on the device: a copy. A factory that names no
            # device makes a host tensor (on the card as on the CPU)
            i = _FACTORIES[name]
            data = args[i] if len(args) > i else kwargs.get("data")
            if not isinstance(data, torch.Tensor) and \
                    getattr(out, "device", None) is not None and \
                    out.device.type == self.device.type and \
                    (name == "new_tensor" or kwargs.get("device") is not None):
                self._note(("h2d_copy", name))
        elif name in _MOVES:
            self._note(_move_hazard(name, args, out))
        if self.pins is not None:
            for t in _tensors(out, []):
                self._made.add(t.untyped_storage().data_ptr())
        return out


# ---------------------------------------------------------------------------
# graphs and their store
# ---------------------------------------------------------------------------

class StageGraph:
    """One captured stage function: its static inputs and outputs, the
    counter deltas of one run, and a CUDA graph with its pool (or, on the
    CPU, the closure it re-runs). `nbytes`: what it holds outside its
    pool (its static inputs; on the CPU its outputs too)."""

    def __init__(self, key: str, device, inputs: dict, outputs: dict,
                 counts: tuple, base: int, owner: int, nbytes: int,
                 graph=None, pool=None, fn=None, pins=None):
        self.key, self.device = key, device
        self.inputs, self.outputs = inputs, outputs
        self.counts, self.base, self.owner = counts, base, owner
        self.nbytes = nbytes
        self.graph, self.pool, self.fn, self.pins = graph, pool, fn, pins

    def replay(self, arrays: dict, base: int) -> dict:
        """Copy `arrays` (host arrays or device tensors) into the static
        inputs, run, and return clones of the outputs, with the operator
        ids in '#err' moved to `base`."""
        for k, a in arrays.items():
            if isinstance(a, np.ndarray):
                copy_to_device(self.inputs[k], a)
            else:
                self.inputs[k].copy_(a)
        if self.graph is not None:
            self.graph.replay()
        else:
            before = _read_counts()
            outs = self.fn(self.inputs)
            _set_counts(before)
            for k, v in self.outputs.items():
                got = outs[k]
                if got.shape != v.shape or got.dtype != v.dtype:
                    raise RuntimeError(
                        f"stage graph: output {k} changed from "
                        f"{tuple(v.shape)} {v.dtype} to {tuple(got.shape)} "
                        f"{got.dtype} between runs")
                v.copy_(got)
        _add_counts(self.counts)
        outs = {k: v.clone() for k, v in self.outputs.items()}
        _shift_err(outs, base - self.base)
        return outs


def _shift_err(outs: dict, d: int) -> None:
    if d and "#err" in outs:
        e = outs["#err"]
        outs["#err"] = torch.where(e != 0, e + (d << 8), e)


def _nbytes(arrays: dict) -> int:
    return sum(t.numel() * t.element_size() for t in arrays.values())


class _Pool:
    """A memory pool of CUDA graphs on one device. Its graphs replay one
    after another on one stream, so a capture reuses what earlier
    captures into it freed. `nbytes`: what the captures added to the
    card's reserved memory, all of which the pool keeps until its last
    graph is gone; torch then returns it to the allocator."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.nbytes = 0


class GraphStore:
    """Graphs by key, bounded by the bytes they hold on their devices:
    each graph's own (`StageGraph.nbytes`) and those of the pools that
    hold a graph of the store. The least recently used graphs go first; a
    pool's bytes leave with its last graph. A new capture goes into its
    device's current pool until that pool holds half the capacity; later
    captures start another, so that evicting the older graphs frees the
    older pool."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self._graphs: "OrderedDict[str, StageGraph]" = OrderedDict()
        self._current: dict = {}    # str(device) -> _Pool for new captures
        self.evictions = 0

    def __len__(self):
        return len(self._graphs)

    def graphs(self):
        return self._graphs.values()

    def pools(self) -> list:
        """The pools that hold a graph of the store."""
        return list({id(g.pool): g.pool for g in self._graphs.values()
                     if g.pool is not None}.values())

    def pool_bytes(self) -> int:
        return sum(p.nbytes for p in self.pools())

    @property
    def nbytes(self) -> int:
        return sum(g.nbytes for g in self._graphs.values()) + \
            self.pool_bytes()

    def _cap(self, device) -> int:
        return self.capacity if self.capacity is not None else \
            default_capacity(device)

    def pool(self, device) -> _Pool:
        """The pool a new capture on the CUDA `device` goes into."""
        p = self._current.get(str(device))
        if p is None or p.nbytes >= self._cap(device) // 2 or \
                all(p is not q for q in self.pools()):
            # full, or released with its last graph
            p = self._current[str(device)] = _Pool()
        return p

    def get(self, key: str) -> Optional[StageGraph]:
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
        return g

    def put(self, g: StageGraph) -> None:
        self._graphs.pop(g.key, None)
        self._graphs[g.key] = g
        self._evict_to(self._cap(g.device), keep=1)

    def shrink(self, capacity: int) -> None:
        """Evict the least recently used graphs until the store holds at
        most `capacity` bytes."""
        self._evict_to(capacity, keep=0)

    def _evict_to(self, cap: int, keep: int) -> None:
        while self.nbytes > cap and len(self._graphs) > keep:
            self._graphs.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._graphs.clear()
        self._current.clear()


def default_capacity(device) -> int:
    """The store's bytes: an eighth of the card's memory, 1 GiB on the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 8
    return 1 << 30


STORE = GraphStore()
_DECLINED: dict[str, tuple] = {}     # key -> (reason, detail)
_STREAMS: dict = {}                  # str(device) -> its side stream


def _side_stream(device) -> "torch.cuda.Stream":
    """The one stream a device's warm-ups and captures run on: the
    allocator reuses a freed block, in a graph pool too, only for the
    stream that freed it."""
    s = _STREAMS.get(str(device))
    if s is None:
        s = _STREAMS[str(device)] = torch.cuda.Stream(device)
    return s


def declines() -> dict:
    """{key: (reason, detail)} of the keys that could not be captured."""
    return dict(_DECLINED)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def run_stage(stage, part, device, compaction: bool, fold: bool) -> dict:
    """The stage function's outputs over partition `part` on `device`:
    by a replay of its graph, by capturing one, or eagerly (under `eager()`
    or where the key declined). Raises NotCompilable as the function
    does."""
    t0 = time.perf_counter()
    if _EAGER:
        return _run_eager(stage, part, device, compaction, fold, None, t0)
    view = part.device
    arrays = C.host_arrays(part) if view is None else view.arrays
    flags = _flags(stage, part, device, compaction, fold)
    key = fingerprint_stage(stage, arrays, flags)
    g = STORE.get(key)
    if g is not None:
        return _replay(stage, g, arrays, t0)
    host = arrays if view is None else None
    declined = _DECLINED.get(key)
    if declined is not None:
        _count_decline(declined[0])
        return _run_eager(stage, part, device, compaction, fold, host, t0)
    return _capture(stage, part, device, compaction, fold, host, flags,
                    key, t0)


def _run_eager(stage, part, device, compaction, fold, host, t0) -> dict:
    batch = C.stage_partition(part, device, host=host)
    outs = stage.build_device_fn(part.schema, compaction=compaction,
                                 fold=fold)(batch.arrays)
    STATS["eager_dispatches"] += 1
    STATS["eager_dispatch_s"] += time.perf_counter() - t0
    return outs


def _count_decline(reason: str) -> None:
    d = STATS["graph_declined"]
    d[reason] = d.get(reason, 0) + 1


def _replay(stage, g: StageGraph, arrays: dict, t0) -> dict:
    seen = stage.__dict__.setdefault("_cq_seen", set())
    if g.key not in seen:
        seen.add(g.key)
        if g.owner != _token(stage):
            STATS["dedup_hits"] += 1
    outs = g.replay(arrays, _op_base(stage))
    STATS["graph_replays"] += 1
    STATS["replay_dispatch_s"] += time.perf_counter() - t0
    return outs


def _static_inputs(part, device, host) -> dict:
    """Staged arrays of `part` owned by the graph, which later partitions
    overwrite: a host partition staged on the card is copied into new
    tensors already; on the CPU they may share the partition's host leaves,
    and a handed-off view's arrays belong to the partition, so those are
    copied."""
    batch = C.stage_partition(part, device, host=host)
    if part.device is None and device.type == "cuda":
        return batch.arrays
    return {k: t.clone() for k, t in batch.arrays.items()}


def _capture(stage, part, device, compaction, fold, host, flags, key,
             t0) -> dict:
    inputs = _static_inputs(part, device, host)
    fn = stage.build_device_fn(part.schema, compaction=compaction, fold=fold)
    before = _read_counts()
    # on the card a warm-up copies the constants it is the first to use
    # (ops/strings.py `_on`, the NFA tables) once; the capture, strict,
    # sees every copy that would recur. The CPU has no capture, so its
    # warm-up looks for copies: its constant uploads copy nothing there
    # and are not seen, and a factory counts only where it names the
    # device (`_Guard`)
    guard = _Guard(device, copies=device.type != "cuda")
    if device.type == "cuda":
        cur = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), guard:
            outs = fn(inputs)
        cur.wait_stream(side)
        for t in outs.values():
            t.record_stream(cur)
    else:
        with guard:
            outs = fn(inputs)
    # the warm-up ran: its launches count. It serves this partition, whose
    # inputs the next replay overwrites: an output that is an input's
    # memory is cloned
    counts = tuple(a - b for a, b in zip(_read_counts(), before))
    held = {t.untyped_storage().data_ptr() for t in inputs.values()}
    outs = {k: v.clone() if v.untyped_storage().data_ptr() in held else v
            for k, v in outs.items()}
    # a decision the warm-up made (the fold left to the host) moves the
    # key: the graph goes under the key later partitions ask for
    flags2 = _flags(stage, part, device, compaction, fold)
    key2 = key if flags2 == flags else fingerprint_stage(stage, inputs,
                                                         flags2)
    if guard.reason is not None:
        _decline(guard.reason, key, key2)
    elif STORE.get(key2) is None:
        g, why = _build_graph(fn, inputs, outs, counts, device, key2, stage)
        if g is None:
            _decline(why, key, key2)
        else:
            STORE.put(g)
            stage.__dict__.setdefault("_cq_seen", set()).add(key2)
    STATS["capture_dispatches"] += 1
    STATS["capture_dispatch_s"] += time.perf_counter() - t0
    return outs


def _decline(why: tuple, *keys) -> None:
    for k in keys:
        _DECLINED[k] = why
    _count_decline(why[0])


def _build_graph(fn, inputs, warm_outs, counts, device, key, stage):
    """(graph, None): `fn` captured over `inputs` on CUDA, or kept with
    static outputs shaped as the warm-up's on the CPU; (None, (reason,
    detail)) where the capture failed."""
    t0 = time.perf_counter()
    base, owner = _op_base(stage), _token(stage)
    if device.type != "cuda":
        outputs = {k: torch.empty_like(v) for k, v in warm_outs.items()}
        g = StageGraph(key, device, inputs, outputs, counts, base, owner,
                       _nbytes(inputs) + _nbytes(outputs), fn=fn)
    else:
        pool = STORE.pool(device)
        graph = torch.cuda.CUDAGraph()
        guard = _Guard(device, strict=True, pin=True)
        side = _side_stream(device)
        torch.cuda.synchronize(device)
        reserved = torch.cuda.memory_reserved(device)
        before = _read_counts()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool.handle)
                try:
                    with guard:
                        outputs = fn(inputs)
                finally:
                    graph.capture_end()
            # what the launches the graph holds add to the counters
            counts = tuple(a - b for a, b in zip(_read_counts(), before))
        except _Decline as e:
            return None, (e.reason, e.detail)
        except RuntimeError as e:
            torch.cuda.synchronize(device)
            return None, ("capture_error", str(e)[:200])
        finally:
            _set_counts(before)      # the capture ran nothing
        # a private pool's segments come only from its captures
        grown = max(torch.cuda.memory_reserved(device) - reserved, 0)
        pool.nbytes += grown
        STATS["pool_bytes"] += grown
        g = StageGraph(key, device, inputs, outputs, counts, base, owner,
                       _nbytes(inputs), graph=graph, pool=pool,
                       pins=list(guard.pins.values()))
    STATS["stage_compiles"] += 1
    STATS["compile_s"] += time.perf_counter() - t0
    return g, None


clear()

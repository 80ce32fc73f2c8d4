"""The join stage: a broadcast build side and a probe on the device
(counterpart of `tuplex_tpu/exec/joinexec.py`; reference:
PhysicalPlan.cc:145-178, LocalBackend.cc:213 executeHashJoinStage,
HybridHashTable.h:46-60).

`exec/local.py` `run_plan` runs the build (right) side's plan first and
hands its partitions over; its exceptions are the job's. Then, on the
device:

  * build: the key of every build row, boxed rows with a key of the key's
    type included, as a canonical byte signature (runtime/columns.py
    `key_signature_matrix`) packed into 64-bit words; `torch.unique` sorts and
    deduplicates them, with a count per key, and a stable sort of the
    inverse gives each key's rows in the build side's order (CSR), and
    the probe's search index is built over the unique words once
    (ops/join.py `probe_index`);
  * probe: each left partition's key words against the index (ops/join.py
    `join_probe`: the CUDA kernel csrc/join_probe.cu on the card);
  * expand: each left row repeats once per match (`repeat_interleave`,
    once when a left join finds none), and every leaf of both sides is
    gathered at those rows, whatever the column's layout (tuples, Options
    of tuples and host objects too); a left join's unmatched rows get None
    on the right.

The device handoff (exec/local.py): a left partition handed off by the
stage before is probed and gathered from its device view (its key words
from the view's key arrays, the few boxed rows' keys written on the
device), and when the join's output feeds another stage, join or
aggregate, the gathered leaves stay on the device as the output's view,
with host leaves fetched only when read; output rows assembled in Python
are not `#rowvalid` there. The build side's device copy is charged to the
stage's handoff budget once.

Output rows keep the left rows' order, each with its matches in the build
side's order, as a plain loop over a dict of lists gives them
(plan/joins.py `join_rows`). A row whose left or build row is boxed
(outside the normal case) is assembled in Python and boxed in the output,
in its slot. As in the loop, a boxed left row without a key (too short,
or not a tuple) is an exception record; a boxed build row without a
hashable key is never matched, and a left row with an unhashable key
matches nothing. An empty build side matches nothing.

Build partitions of different schemas are brought to one: each column
takes the super type of its types (the first partition's, where they
have none but `pyobject`), and the rows of a partition of another schema
are encoded anew against it, those that do not conform boxed.

String keys of different widths on the two sides are compared at the build
side's width: a left key is padded to it, or cut; a cut key is longer than
every build key, and its length bytes keep it unequal to all of them.

The host dict path joins decoded rows in Python. It is taken only where a
signature cannot carry Python's equality: keys of different types on the
two sides (1 == 1.0 == True), counting a boxed key of another type than
its column and a key column of mixed types (`pyobject`), and NaN float
keys. A build side with such a key sends every
left partition there; a left partition with one goes there alone.
`host_probed_rows` counts the left rows that take it. Key columns of other
types than bool, int, float and str (and their Options) are not ported:
they raise.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from ..core import typesys as T
from ..core.errors import TuplexException
from ..ops.join import flip, join_probe, probe_index
from ..plan.joins import join_rows, joined_row
from ..runtime import columns as C
from ..runtime import xferstats
from ..runtime.xferstats import to_device, to_host

_KEY_TYPES = (T.I64, T.F64, T.BOOL, T.STR, T.NULL)
_NP_DTYPES = {torch.int64: np.int64, torch.float64: np.float64,
              torch.bool: np.bool_}


class JoinExecutor:
    def __init__(self, backend):
        self.device = backend.device
        self.budget = backend.handoff_budget

    def execute(self, stage, partitions: list, build_parts: list,
                consumer=False):
        """Join the left `partitions` with `build_parts`, the output of the
        build side's plan. `consumer` is who takes the join's output
        (plan/physical.py `consumer_kind`)."""
        from .local import ExceptionRecord, Handoff, StageResult

        op = stage.op
        t0 = time.perf_counter()
        snap = xferstats.snapshot()
        handoff = Handoff(self.budget, consumer)
        big = _concat(build_parts, build_parts[0].schema if build_parts
                      else op.right.schema())
        build = _Build.make(op, big, self.device)
        if build is not None:
            handoff.left -= build.nbytes
        t_build = time.perf_counter() - t0
        host_build = None
        out_parts, device_rows, host_rows = [], 0, 0
        errors: list = []
        for part in partitions:
            outp = build.probe(part, errors, handoff) \
                if build is not None else None
            if outp is not None:
                device_rows += part.num_rows
            else:
                if host_build is None:
                    host_build = _row_values(big)
                outp = _host_join(op, part, big.schema, host_build, errors)
                handoff.offer_host(outp, self.device)
                host_rows += part.num_rows
            C.release_view(part)
            out_parts.append(outp)
        excs = [ExceptionRecord(op.id, name, row) for row, name in errors]
        return StageResult(out_parts, excs, {
            **handoff.metrics(), **xferstats.since(snap),
            "wall_s": time.perf_counter() - t0, "build_s": t_build,
            "build_rows": big.num_rows,
            "build_keys": build.n_keys if build else 0,
            "key_words": build.nw if build else 0,
            "device_probed_rows": device_rows,
            "host_probed_rows": host_rows,
            "rows_out": sum(p.num_rows for p in out_parts),
            "exception_rows": len(errors)})


# ---------------------------------------------------------------------------
# the device path
# ---------------------------------------------------------------------------

def _base(t: T.Type) -> T.Type:
    return t.without_option() if t.is_optional() else t


def _key_index(schema: T.RowType, name: str) -> int:
    if name not in (schema.columns or ()):
        raise TuplexException(f"join: no key column {name!r} in "
                              f"{list(schema.columns or ())}")
    return schema.columns.index(name)


def _leaf_tensors(leaf, device) -> dict:
    """A numeric or str leaf's arrays on `device`: 'd' data, 'b' bytes,
    'l' lengths, 'v' validity (where the leaf has them); {} for other
    leaves, which stay on the host. A leaf of tensors (a device view's)
    is not copied."""
    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        return to_device(a, device)

    out = {}
    if isinstance(leaf, C.NumericLeaf):
        out["d"] = put(leaf.data)
    elif isinstance(leaf, C.StrLeaf):
        out["b"] = put(leaf.bytes)
        out["l"] = put(leaf.lengths)
    else:
        return out
    if leaf.valid is not None:
        out["v"] = put(leaf.valid)
    return out


def _boxed_rows(part: C.Partition) -> dict:
    """row -> the partition's boxed row as the host dict path sees it (a
    one-column row in a 1-tuple)."""
    if len(part.schema.columns) != 1:
        return dict(part.fallback)
    return {i: v if isinstance(v, tuple) and len(v) == 1 else (v,)
            for i, v in part.fallback.items()}


def _hashable(v) -> bool:
    try:
        hash(v)
    except TypeError:
        return False
    return True


class KeyLayout:
    """The build side's key signature layout, which every probe takes on:
    the key's base type, a str key's byte width, and whether a valid byte
    follows (the build side has None keys, or an Option key column)."""

    def __init__(self, base: T.Type, width: int, has_valid: bool):
        self.base, self.width, self.has_valid = base, width, has_valid

    def conforms(self, keys: dict) -> bool:
        """Whether every key of `keys` (row -> a boxed row's key) is None
        or of the key's type."""
        return all(v is None or T.python_value_conforms(v, self.base)
                   for v in keys.values())

    def key_leaf(self, leaf, keys: dict, n: int, device):
        """(leaf, unmatchable): the key leaf of n rows (host arrays or a
        device view's tensors) in this layout, a copy on `device` with the
        boxed rows' keys (`keys`: row -> a value that conforms) written
        into their slots there, and the [n] bool tensor of the rows whose
        None key nothing on the build side equals (the layout has no
        valid byte)."""
        unmatchable = torch.zeros(n, dtype=torch.bool, device=device)
        if self.base is T.NULL:
            return C.NullLeaf(n), unmatchable
        t = _leaf_tensors(leaf, device)
        if "b" in t:
            w = max(self.width, 1)
            b = t["b"][:, :w]
            if b.shape[1] < w:
                b = torch.nn.functional.pad(b, (0, w - b.shape[1]))
            out = C.StrLeaf(b.to(torch.uint8).clone(),
                            t["l"].to(torch.int32).clone())
        else:
            out = C.NumericLeaf(t["d"].clone())
        valid = t["v"].clone() if "v" in t else None
        none = np.asarray([i for i, v in keys.items() if v is None],
                          dtype=np.int64)
        some = np.asarray([i for i, v in keys.items() if v is not None],
                          dtype=np.int64)
        if len(none):
            if valid is None:
                valid = torch.ones(n, dtype=torch.bool, device=device)
            valid[to_device(none, device)] = False
        if len(some):
            at = to_device(some, device)
            if valid is not None:
                valid[at] = True
            vals = [keys[i] for i in some.tolist()]
            if isinstance(out, C.StrLeaf):
                enc = C.encode_str_leaf(vals, False)
                mat = np.zeros((len(vals), out.width), dtype=np.uint8)
                cw = min(out.width, enc.width)
                mat[:, :cw] = enc.bytes[:, :cw]
                out.bytes[at] = to_device(mat, device)
                out.lengths[at] = to_device(enc.lengths, device)
            else:
                out.data[at] = to_device(np.asarray(
                    vals, dtype=_NP_DTYPES[out.data.dtype]), device)
        if self.has_valid:
            out.valid = valid if valid is not None else \
                torch.ones(n, dtype=torch.bool, device=device)
        elif valid is not None:
            unmatchable = ~valid
        return out, unmatchable

    def words(self, leaf, device) -> Optional[torch.Tensor]:
        """[N, nw] int64 words of a key_leaf() on `device`; None for a NaN
        key."""
        t = T.option(self.base) if getattr(leaf, "valid", None) is not None \
            else self.base
        sig = C.key_signature_matrix(
            C.Partition(T.row_of(["key"], [t]), len(leaf), {"0": leaf}),
            [0], device=device)
        return None if sig is None else C.pack_sig_words(sig)


class _Build:
    """The build side on the device: its rows (every leaf), the sorted
    unique key words, and per key its count and first slot in `order`,
    the build rows sorted by key and then by position."""

    @classmethod
    def make(cls, op, big: C.Partition, device) -> Optional["_Build"]:
        """The build side of `big`, the build partitions as one; None when
        its keys take the host dict path (a key of another type than its
        column, or a NaN)."""
        self = cls()
        self.op, self.device = op, device
        self.rk = _key_index(big.schema, op.right_column)
        self.n_rows = n = big.num_rows
        rows = _boxed_rows(big)
        reach = np.ones(n, dtype=np.bool_)     # rows with a hashable key
        keys = {}
        for i, r in rows.items():
            try:
                keys[i] = r[self.rk]
            except (TypeError, IndexError):
                reach[i] = False
                continue
            if not _hashable(keys[i]):
                reach[i] = False
                del keys[i]
        self.n_keys, self.nw = 0, 0
        if reach.any():
            rt = big.schema.types[self.rk]
            if rt is T.PYOBJECT:
                return None      # a column of keys of mixed types
            if _base(rt) not in _KEY_TYPES:
                raise TuplexException(
                    f"join on a key of type {rt} is not ported (keys are "
                    "bool, int, float, str or Options of them)")
            leaf = big.leaves[str(self.rk)]
            # every build key fits the width whole: a probe key cut to it
            # is longer than all of them
            width = max([leaf.width if isinstance(leaf, C.StrLeaf) else 0] +
                        [len(v.encode("utf-8")) for v in keys.values()
                         if isinstance(v, str)])
            self.layout = KeyLayout(
                _base(rt), width, getattr(leaf, "valid", None) is not None
                or any(v is None for v in keys.values()))
            if not self.layout.conforms(keys):
                return None      # 1 == 1.0 == True: Python's equality
            words = self.layout.words(
                self.layout.key_leaf(leaf, keys, n, device)[0], device)
            if words is None:
                return None      # NaN != NaN
            kept = torch.from_numpy(np.nonzero(reach)[0]).to(device)
            uniq, inverse, counts = torch.unique(
                flip(words[kept]), dim=0, return_inverse=True,
                return_counts=True)
            self.n_keys, self.nw = uniq.shape
            self.index = probe_index(flip(uniq))
            self.counts = counts
            self.offsets = torch.cumsum(counts, 0) - counts
            self.order = kept[torch.sort(inverse, stable=True).indices]
        # an empty build side gathers its (masked) right values from one
        # placeholder row
        self.big = big if n else C.gather_partition(
            big, np.zeros(0, np.int64), np.zeros(0, np.int64), 1)
        self.rows = rows
        self.leaves = {p: _leaf_tensors(lf, device)
                       for p, lf in self.big.leaves.items()}
        self.nbytes = sum(a.nbytes for t in self.leaves.values()
                          for a in t.values())
        boxed = np.zeros(self.big.num_rows, dtype=np.bool_)
        boxed[list(rows)] = True
        self.boxed = to_device(boxed, device)
        return self

    def probe(self, part: C.Partition, errors: list, handoff
              ) -> Optional[C.Partition]:
        """The partition joined on the device, its keyless boxed rows'
        exception records appended to `errors`; None when it must take the
        host dict path. `handoff` (exec/local.py `Handoff`) routes the
        output: its gathered leaves stay on the device as its view, or
        are fetched."""
        op, dev = self.op, self.device
        lk = _key_index(part.schema, op.left_column)
        n = part.num_rows
        src = C.source_leaves(part)
        rows = _boxed_rows(part)
        keys, errs = {}, []
        keep = np.ones(n, dtype=np.bool_)       # rows with a key
        nohash = np.zeros(n, dtype=np.bool_)    # rows with an unhashable one
        for i in sorted(rows):
            try:
                key = rows[i][lk]
            except (TypeError, IndexError) as e:
                errs.append((rows[i], type(e).__name__))
                keep[i] = False
                continue
            if _hashable(key):
                keys[i] = key
            else:
                nohash[i] = True
        if self.n_keys == 0 or n == 0:
            pos = torch.zeros(n, dtype=torch.int64, device=dev)
            matched = torch.zeros(n, dtype=torch.bool, device=dev)
        else:
            if _base(part.schema.types[lk]) is not self.layout.base or \
                    not self.layout.conforms(keys):
                return None      # 1 == 1.0 == True: Python's equality
            leaf, unmatchable = self.layout.key_leaf(src[str(lk)], keys, n,
                                                     dev)
            words = self.layout.words(leaf, dev)
            if words is None:
                return None      # NaN != NaN
            pos, matched = join_probe(words, self.index)
            matched &= ~(unmatchable | to_device(nohash, dev))
        errors.extend(errs)
        cnt = torch.where(matched, self.counts[pos], 0) if self.n_keys \
            else torch.zeros(n, dtype=torch.int64, device=dev)
        left = op.how == "left"
        per = torch.where(matched, cnt, 1) if left else cnt
        per = torch.where(to_device(keep, dev), per, 0)
        m = int(per.sum())
        left_idx = torch.repeat_interleave(
            torch.arange(n, device=dev), per, output_size=m)
        has = matched[left_idx]
        if self.n_keys:
            starts = torch.cumsum(per, 0) - per
            intra = torch.arange(m, device=dev) - starts[left_idx]
            slot = torch.clamp(self.offsets[pos[left_idx]] + intra,
                               max=self.n_rows - 1)
            build_row = torch.where(has, self.order[slot], 0)
        else:
            build_row = torch.zeros(m, dtype=torch.int64, device=dev)

        cols, types, sources = op.output_layout(part.schema, self.big.schema)
        lleaves = {p: _leaf_tensors(lf, dev) for p, lf in src.items()}
        gather = [_Gather(src, lleaves, left_idx, None),
                  _Gather(self.big.leaves, self.leaves, build_row,
                          has if left else None)]
        leaves = {}
        for j, (side, ci) in enumerate(sources):
            for path, lt in C.flatten_type(types[j], str(j)):
                leaves[path] = gather[side].leaf(
                    str(ci) + path[len(str(j)):], lt, m)
        outp = C.Partition(schema=T.row_of(cols, types), num_rows=m,
                           start_index=part.start_index)
        view = None
        if handoff.route(C.view_nbytes(leaves, m)):
            view = C.gather_view(leaves, m, dev)
            C.hand_off(outp, view)
        else:
            outp.leaves = {p: C.leaf_to_host(lf) for p, lf in leaves.items()}
        lbox = np.zeros(n, dtype=np.bool_)
        lbox[list(rows)] = True
        boxed_out = to_device(lbox, dev)[left_idx] | \
            (has & self.boxed[build_row])
        if bool(boxed_out.any()):
            self._box_rows(part, rows, outp, lk, boxed_out, left_idx,
                           build_row, has)
            if view is not None:
                view.arrays["#rowvalid"][:m] &= ~boxed_out
        return outp

    def _box_rows(self, part, rows, outp, lk, boxed_out, left_idx,
                  build_row, has) -> None:
        """Output rows with a boxed left or build row, assembled in Python
        as the host dict path assembles them, and boxed in their slots."""
        slots = torch.nonzero(boxed_out)[:, 0]
        li = to_host(left_idx[slots])
        bi = to_host(build_row[slots])
        hv = to_host(has[slots]).tolist()
        lrows = _rows_at(part, rows, li)
        brows = _rows_at(self.big, self.rows, bi)
        n_right = len(self.big.schema.columns)
        outp.normal_mask = np.ones(outp.num_rows, dtype=np.bool_)
        for s, lrow, brow, h in zip(to_host(slots).tolist(), lrows,
                                    brows, hv):
            outp.normal_mask[s] = False
            outp.fallback[s] = joined_row(lrow, lk, brow if h else None,
                                          self.rk, n_right)


class _Gather:
    """One side's leaves (`leaves`: host leaves or a device view's, by
    path; `dev_leaves`: their arrays on the device) gathered at its output
    rows `idx` (device int64 [m]); with `has`, as Option: None where a left
    join found no match. Output leaves are tensors on the device, but for
    host objects."""

    def __init__(self, leaves: dict, dev_leaves: dict,
                 idx: torch.Tensor, has: Optional[torch.Tensor]):
        self.leaves, self.dev_leaves, self.idx, self.has = \
            leaves, dev_leaves, idx, has
        self._host = None

    def leaf(self, path: str, lt: T.Type, m: int):
        """The output leaf of type `lt` from the source leaf at `path`."""
        src = self.leaves.get(path)
        has = self.has
        if src is None:
            # the whole-tuple validity of a tuple column made Option
            return C.NumericLeaf(has)
        if isinstance(src, C.NullLeaf):
            if has is not None and _base(lt) is T.EMPTYTUPLE:
                return C.NumericLeaf(torch.zeros_like(has), has)
            return C.NullLeaf(m)
        if isinstance(src, C.ObjectLeaf):
            if self._host is None:
                self._host = to_host(self.idx).tolist()
            vals = [src.values[i] for i in self._host]
            if has is not None:
                vals = [v if h else None
                        for v, h in zip(vals, to_host(has).tolist())]
            return C.ObjectLeaf(vals)
        g = {k: a[self.idx] for k, a in self.dev_leaves[path].items()}
        if has is not None:
            g = {"d": g["d"] & has} if path.endswith("#opt") else \
                _none_where_unmatched(g, has)
        if "b" in g:
            return C.StrLeaf(g["b"], g["l"], g.get("v"))
        return C.NumericLeaf(g["d"], g.get("v"))


def _none_where_unmatched(g: dict, has: torch.Tensor) -> dict:
    """A right leaf's gathered arrays as Option: None (and zeroed) where a
    left join's row found no match."""
    out = {"v": has if "v" not in g else g["v"] & has}
    for k in ("d", "b", "l"):
        if k in g:
            a = g[k]
            keep = has if a.dim() == 1 else has[:, None]
            out[k] = torch.where(keep, a, torch.zeros_like(a))
    return out


def _rows_at(part: C.Partition, boxed: dict, idx: np.ndarray) -> list:
    """The rows at `idx` as the host dict path sees them: value tuples, a
    boxed row as `_boxed_rows` gives it."""
    normal = [i for i in idx.tolist() if i not in boxed]
    decoded = dict(zip(normal, (tuple(r.values)
                                for r in C.decode_rows(part, normal))))
    return [boxed[i] if i in boxed else decoded[i] for i in idx.tolist()]


def _common_schema(schemas: list) -> T.RowType:
    """The schemas' columns, each typed with the super type of its types
    (the first schema's type where that is `pyobject`)."""
    first = schemas[0]
    types = list(first.types)
    for s in schemas[1:]:
        if len(s.types) != len(types):
            continue
        for i, t in enumerate(s.types):
            u = T.super_type(types[i], t)
            if u is not T.PYOBJECT:
                types[i] = u
    return T.row_of(first.columns, types)


def _concat(parts: list, schema: T.RowType) -> C.Partition:
    """The partitions as one of one schema (`schema` when there are no
    rows), boxed rows kept in their slots; a partition of another schema
    than the common one is encoded anew against it."""
    parts = [p for p in parts if p.num_rows]
    if not parts:
        return C.build_partition([], schema)
    schema = _common_schema([p.schema for p in parts])
    parts = [p if p.schema == schema else
             C.build_partition(C.partition_to_pylist(p), schema)
             for p in parts]
    n = sum(p.num_rows for p in parts)
    leaves: dict[str, Any] = {}
    for path, first in parts[0].leaves.items():
        ls = [p.leaves[path] for p in parts]
        valid = None
        if any(getattr(lf, "valid", None) is not None for lf in ls):
            valid = np.concatenate([
                lf.valid if getattr(lf, "valid", None) is not None
                else np.ones(len(lf), dtype=np.bool_) for lf in ls])
        if isinstance(first, C.NumericLeaf):
            leaves[path] = C.NumericLeaf(
                np.concatenate([lf.data for lf in ls]), valid)
        elif isinstance(first, C.StrLeaf):
            w = max(lf.width for lf in ls)
            leaves[path] = C.StrLeaf(
                np.concatenate([C.pad_to(lf.bytes, w, axis=1) for lf in ls]),
                np.concatenate([lf.lengths for lf in ls]), valid)
        elif isinstance(first, C.NullLeaf):
            leaves[path] = C.NullLeaf(n)
        else:
            leaves[path] = C.ObjectLeaf([v for lf in ls for v in lf.values])
    big = C.Partition(schema=schema, num_rows=n, leaves=leaves)
    off = 0
    for p in parts:
        for i, v in p.fallback.items():
            big.fallback[off + i] = v
        off += p.num_rows
    if big.fallback:
        big.normal_mask = np.ones(n, dtype=np.bool_)
        big.normal_mask[list(big.fallback)] = False
    return big


# ---------------------------------------------------------------------------
# the host dict path
# ---------------------------------------------------------------------------

def _row_values(part: C.Partition) -> list:
    rows = C.partition_to_pylist(part)
    if len(part.schema.columns) == 1:
        return [r if isinstance(r, tuple) and len(r) == 1 else (r,)
                for r in rows]
    return rows


def _host_join(op, part: C.Partition, rschema: T.RowType, build_rows: list,
               errors: list) -> C.Partition:
    """The partition joined by Python's dict equality over decoded rows."""
    lk = _key_index(part.schema, op.left_column)
    rk = _key_index(rschema, op.right_column)
    values = join_rows(op, _row_values(part), build_rows, lk, rk,
                       len(rschema.columns),
                       on_error=lambda row, e: errors.append(
                           (row, type(e).__name__)))
    cols, types, _ = op.output_layout(part.schema, rschema)
    schema = T.row_of(cols, types)
    if not values:
        return C.Partition(schema=schema, num_rows=0,
                           start_index=part.start_index)
    return C.build_partition(values, schema, start_index=part.start_index)

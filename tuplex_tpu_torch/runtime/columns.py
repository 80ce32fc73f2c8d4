"""Columnar host memory layout + host<->device staging (counterpart of
`tuplex_tpu/runtime/columns.py`).

Same layout as the reference package:

  * every logical column is decomposed into fixed-shape leaf arrays
      - numeric leaves: one array [N]
      - str leaves:     uint8 bytes [N, W] zero-padded + int32 lengths [N]
      - Option adds a validity bool [N]
      - nested tuples flatten to dotted paths ("col.0.1")
  * a partition covers a contiguous range of original row positions; rows
    that do NOT conform to the normal-case schema keep their slot
    (placeholder zeros) and live boxed in `fallback`, which preserves order
    for the dual-mode merge.
  * device staging pads N up to a bucket (and W per str column) so kernels
    see few distinct shapes.

Host leaves are numpy; `stage_partition` copies them into torch tensors on
the run's device. Flat schemas encode and decode through the native module
(`tuplex_tpu_torch.native`) when it is available, else through the Python
loops here, with the same rows and the same fallback rows.

The device handoff between stages: a partition that a stage hands to the
next one on the device carries a `DeviceView` (`Partition.device`), the
arrays `stage_partition` would stage from its leaves, already on the
device, and its host leaves are `LazyLeaves`, each fetched from the view
only when something reads it. `stage_partition` and `stage_rows` take
their arrays from the view, `decode_rows` and `decode_key_tuples` gather
their rows from it on the device and fetch only those.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..core import typesys as T
from ..core.errors import TuplexException
from ..core.row import Row
from .xferstats import COUNTS, to_device, to_host

LEAF_NUMERIC = {T.BOOL: np.bool_, T.I64: np.int64, T.F64: np.float64}


def flatten_type(t: T.Type, path: str = "") -> list[tuple[str, T.Type]]:
    """Leaf (path, type) pairs for a column type. Option wraps leaves; an
    Option[Tuple] column gets an extra "<path>#opt" BOOL leaf for whole-tuple
    validity. Types without a fixed columnar layout become one pyobject
    leaf (host-boxed, interpreter-only)."""
    base = t.without_option() if t.is_optional() else t
    opt = t.is_optional()

    if isinstance(base, T.TupleType):
        out: list[tuple[str, T.Type]] = []
        if opt:
            out.append((f"{path}#opt", T.BOOL))
        for i, e in enumerate(base.elements):
            sub = f"{path}.{i}" if path else str(i)
            out.extend(flatten_type(T.option(e) if opt else e, sub))
        return out
    if base in (T.BOOL, T.I64, T.F64, T.STR, T.NULL, T.EMPTYTUPLE):
        return [(path, t)]
    return [(path, T.PYOBJECT)]


def user_columns(schema: T.RowType):
    """Auto-generated names are '_0', '_1', ... — a schema made only of them
    is an UNNAMED row (UDFs get bare values/tuples)."""
    cols = schema.columns
    if cols and all(c == f"_{i}" for i, c in enumerate(cols)):
        return None
    return cols if cols else None


# ---------------------------------------------------------------------------
# leaf column containers (host, numpy)
# ---------------------------------------------------------------------------

@dataclass
class NumericLeaf:
    data: np.ndarray                      # [N] bool_/int64/float64
    valid: Optional[np.ndarray] = None    # [N] bool_ when Option

    def __len__(self):
        return len(self.data)


@dataclass
class StrLeaf:
    bytes: np.ndarray                     # [N, W] uint8, zero padded
    lengths: np.ndarray                   # [N] int32
    valid: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.lengths)

    @property
    def width(self) -> int:
        return self.bytes.shape[1] if self.bytes.ndim == 2 else 0


@dataclass
class NullLeaf:
    """All-None column: carries only the row count."""
    n: int

    def __len__(self):
        return self.n


@dataclass
class ObjectLeaf:
    """Host-boxed python objects (List/Dict/PYOBJECT leaves)."""
    values: list

    def __len__(self):
        return len(self.values)


Leaf = NumericLeaf | StrLeaf | NullLeaf | ObjectLeaf


def encode_str_leaf(values: Sequence[Optional[str]], optional: bool) -> StrLeaf:
    """Python strings -> zero-padded [N, W] byte matrix in one numpy buffer
    (each row padded with bytes.ljust, then viewed as a matrix)."""
    n = len(values)
    encoded = [v.encode("utf-8") if v is not None else b"" for v in values]
    lens = np.fromiter(map(len, encoded), dtype=np.int32, count=n)
    w = max(int(lens.max()) if n else 0, 1)
    buf = bytearray(b"".join([e.ljust(w, b"\0") for e in encoded]))
    mat = np.frombuffer(buf, dtype=np.uint8).reshape(n, w)
    valid = None
    if optional:
        valid = np.array([v is not None for v in values], dtype=np.bool_)
    return StrLeaf(mat, lens, valid)


def encode_leaf(values: Sequence[Any], t: T.Type) -> Leaf:
    base = t.without_option() if t.is_optional() else t
    opt = t.is_optional()
    n = len(values)
    if base is T.EMPTYTUPLE and opt:
        valid = np.array([v is not None for v in values], dtype=np.bool_)
        return NumericLeaf(np.zeros(n, dtype=np.bool_), valid)
    if base is T.NULL or base is T.EMPTYTUPLE:
        return NullLeaf(n)
    if base is T.STR:
        return encode_str_leaf(values, opt)
    if base in LEAF_NUMERIC:
        dtype = LEAF_NUMERIC[base]
        if opt:
            data = np.zeros(n, dtype=dtype)
            valid = np.zeros(n, dtype=np.bool_)
            for i, v in enumerate(values):
                if v is not None:
                    data[i] = v
                    valid[i] = True
            return NumericLeaf(data, valid)
        return NumericLeaf(np.asarray(values, dtype=dtype))
    return ObjectLeaf(list(values))


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------

def _leaf_paths_for_value(path: str, t: T.Type, v: Any) -> Iterable[tuple[str, Any]]:
    base = t.without_option() if t.is_optional() else t
    opt = t.is_optional()
    if isinstance(base, T.TupleType):
        if opt:
            yield (f"{path}#opt", v is not None)
        for i, e in enumerate(base.elements):
            sub = f"{path}.{i}" if path else str(i)
            et = T.option(e) if opt else e
            yield from _leaf_paths_for_value(sub, et, None if v is None else v[i])
    else:
        yield (path, v)


@dataclass
class Partition:
    """A horizontal slice of a dataset in normal-case columnar layout.

    `schema` is the normal-case RowType. `leaves` maps "<col>" or
    "<col>.<i>..." paths to leaf arrays of length == num_rows.
    Non-conforming row positions are False in `normal_mask` and boxed in
    `fallback` (original python value, pre-conversion).
    """

    schema: T.RowType
    num_rows: int
    leaves: dict[str, Leaf] = field(default_factory=dict)
    normal_mask: Optional[np.ndarray] = None      # [N] bool; None => all normal
    fallback: dict[int, Any] = field(default_factory=dict)
    start_index: int = 0                          # global row offset of row 0
    # the partition's staged arrays on the device, when a stage handed it
    # to its consumer there
    device: Optional["DeviceView"] = field(default=None, compare=False,
                                           repr=False)

    @property
    def user_columns(self):
        """Column names as the user sees them: None when auto-generated."""
        return user_columns(self.schema)

    def n_normal(self) -> int:
        if self.normal_mask is None:
            return self.num_rows
        return int(self.normal_mask.sum())


def build_partition(values: Sequence[Any], schema: T.RowType,
                    start_index: int = 0) -> Partition:
    """Encode boxed python row values into a Partition against `schema`.
    Rows that don't conform keep their position as placeholder slots and
    are boxed into `fallback`."""
    fast = _fast_partition(values, schema, start_index)
    if fast is not None:
        return fast
    n = len(values)
    multi = len(schema.columns) > 1
    if schema.types == (T.STR,) and all(type(v) is str for v in values):
        # text lines: one bulk encode, no per-row conformance walk
        return Partition(schema=schema, num_rows=n,
                         leaves={"0": encode_str_leaf(values, False)},
                         start_index=start_index)

    normal_mask = np.ones(n, dtype=np.bool_)
    fallback: dict[int, Any] = {}
    leaf_types: list[tuple[str, T.Type]] = []
    for ci, ct in enumerate(schema.types):
        leaf_types.extend(flatten_type(ct, str(ci)))
    leaf_values: dict[str, list] = {p: [] for p, _ in leaf_types}
    leaf_type_map = dict(leaf_types)
    placeholders = {p: _placeholder(lt) for p, lt in leaf_types}

    def conforms(row_tuple) -> bool:
        if not (isinstance(row_tuple, tuple) and
                len(row_tuple) == len(schema.columns)):
            return False
        return all(T.python_value_conforms(rv, ct)
                   for rv, ct in zip(row_tuple, schema.types))

    for i, v in enumerate(values):
        row_tuple = v if multi else (v,)
        ok = conforms(row_tuple)
        if not ok and not multi and isinstance(v, tuple) and len(v) == 1:
            row_tuple = v     # single-column rows may arrive as 1-tuples
            ok = conforms(row_tuple)
        if not ok:
            normal_mask[i] = False
            fallback[i] = v
            for p in leaf_values:
                leaf_values[p].append(placeholders[p])
            continue
        for ci, (ct, rv) in enumerate(zip(schema.types, row_tuple)):
            for p, lv in _leaf_paths_for_value(str(ci), ct, rv):
                leaf_values[p].append(lv)

    leaves = {p: encode_leaf(vals, leaf_type_map[p])
              for p, vals in leaf_values.items()}
    mask = None if len(fallback) == 0 else normal_mask
    return Partition(schema=schema, num_rows=n, leaves=leaves,
                     normal_mask=mask, fallback=fallback,
                     start_index=start_index)


# native bulk encode (the reference package's _fast_partition)

_KIND_CODES = {T.I64: 0, T.F64: 1, T.BOOL: 2, T.STR: 3}


def _flat_kinds(schema: T.RowType) -> Optional[list[tuple[int, bool]]]:
    """(kind code, optional) per column when every column is a flat
    primitive (i64, f64, bool, str, each maybe Option), else None."""
    kinds = []
    for t in schema.types:
        code = _KIND_CODES.get(t.without_option() if t.is_optional() else t)
        if code is None:
            return None
        kinds.append((code, t.is_optional()))
    return kinds


def _fast_partition(values: Sequence[Any], schema: T.RowType,
                    start_index: int) -> Optional[Partition]:
    """One C pass per column (one over all row tuples when there are
    several columns) for flat schemas; None when the schema is not flat or
    the native module is not available. Rows whose cells do not conform
    (arity, type, an int beyond int64, None in a non-Option column, a row
    that is not exactly a tuple) are boxed into `fallback`."""
    kinds = _flat_kinds(schema)
    if kinds is None or native.get() is None:
        return None
    n = len(values)
    if len(kinds) > 1:
        encoded, bad = native.encode_rows(list(values),
                                          [code for code, _ in kinds])
    else:
        col = [v[0] if type(v) is tuple and len(v) == 1 else v
               for v in values]
        encode = (native.encode_i64, native.encode_f64, native.encode_bool,
                  native.encode_str)[kinds[0][0]]
        *enc, bad = encode(col)
        encoded = [tuple(enc)]
    bad_rows = set(bad)
    leaves: dict[str, Leaf] = {}
    for ci, (code, opt) in enumerate(kinds):
        leaves[str(ci)], valid = _leaf_from_encoded(code, opt, encoded[ci], n)
        if not opt:   # None in a non-Option column leaves the normal case
            bad_rows.update(np.flatnonzero(~valid).tolist())
    part = Partition(schema=schema, num_rows=n, leaves=leaves,
                     start_index=start_index)
    if bad_rows:
        part.normal_mask = np.ones(n, dtype=np.bool_)
        for i in sorted(bad_rows):
            part.normal_mask[i] = False
            part.fallback[i] = values[i]
    return part


def _leaf_from_encoded(code: int, opt: bool, enc: tuple, n: int):
    """(leaf, validity of every slot) from one column's encoder buffers."""
    if code == 3:
        mat_b, lens_b, valid_b, w = enc
        mat = np.frombuffer(mat_b, dtype=np.uint8).reshape(n, w).copy()
        lens = np.frombuffer(lens_b, dtype=np.int32).copy()
        valid = np.frombuffer(valid_b, dtype=np.bool_).copy()
        return StrLeaf(mat, lens, valid if opt else None), valid
    data_b, valid_b = enc
    data = np.frombuffer(data_b, dtype=(np.int64, np.float64, np.bool_)[code])
    valid = np.frombuffer(valid_b, dtype=np.bool_).copy()
    return NumericLeaf(data.copy(), valid if opt else None), valid


def _placeholder(t: T.Type) -> Any:
    base = t.without_option() if t.is_optional() else t
    if t.is_optional() or base is T.NULL or base is T.EMPTYTUPLE:
        return None
    if base is T.STR:
        return ""
    if base is T.BOOL:
        return False
    if base is T.I64:
        return 0
    if base is T.F64:
        return 0.0
    return None


# ---------------------------------------------------------------------------
# device staging
# ---------------------------------------------------------------------------

def bucket_size(n: int, minimum: int = 8) -> int:
    """Padded size for a real size `n`, quantized to 1/8 of its power-of-two
    floor (waste <= 12.5%), so kernels see few distinct shapes."""
    if n <= 0:
        return 1
    n = max(n, minimum)
    p2 = 1 << (n - 1).bit_length()          # pow2 ceil
    if n == p2:
        return p2
    q = max(minimum, (p2 >> 1) >> 3)        # pow2floor / 8
    return ((n + q - 1) // q) * q


def pad_to(arr: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    cur = arr.shape[axis]
    if cur >= n:
        return arr
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, n - cur)
    return np.pad(arr, pad_width)


@dataclass
class DeviceBatch:
    """The kernel-facing view of a partition: dict of padded tensors.

    arrays keys: for each leaf path P:
        P            -> numeric data     [B]
        P#bytes      -> str bytes        [B, Wb]
        P#len        -> str lengths      [B]
        P#valid      -> validity         [B]      (Option leaves only)
    plus "#rowvalid" -> [B] bool, True for real, normal-case rows.
    `n` is the real row count, `b` the padded bucket size.
    """

    arrays: dict[str, torch.Tensor]
    n: int
    b: int


def _leaf_keys(path: str, leaf):
    """Device array keys for one leaf. [] for layout-free leaves (Null),
    None for host-only (Object)."""
    if isinstance(leaf, NullLeaf):
        return []
    if isinstance(leaf, ObjectLeaf):
        return None
    keys = [path] if isinstance(leaf, NumericLeaf) \
        else [path + "#bytes", path + "#len"]
    if leaf.valid is not None:
        keys.append(path + "#valid")
    return keys


def stage_partition(part: Partition, device: torch.device) -> DeviceBatch:
    """Pad the partition's leaves to bucket shapes and copy them to
    `device`; a partition with a device view gets the view's arrays (in a
    dict of its own), which are those same arrays."""
    view = part.device
    if view is not None:
        return DeviceBatch(arrays=dict(view.arrays), n=view.n, b=view.b)
    n = part.num_rows
    b = bucket_size(n)
    arrays: dict[str, torch.Tensor] = {}

    def put(a: np.ndarray) -> torch.Tensor:
        return to_device(a, device)

    for path, leaf in part.leaves.items():
        ks = _leaf_keys(path, leaf)
        if not ks:   # NullLeaf (layout-free) or host-only ObjectLeaf
            continue
        if isinstance(leaf, NumericLeaf):
            arrays[path] = put(pad_to(leaf.data, b))
        else:
            wb = bucket_size(max(leaf.width, 1))
            arrays[path + "#bytes"] = put(pad_to(pad_to(leaf.bytes, b, 0),
                                                 wb, 1))
            arrays[path + "#len"] = put(pad_to(leaf.lengths, b))
        if path + "#valid" in ks:
            arrays[path + "#valid"] = put(pad_to(leaf.valid, b))
    rowvalid = np.zeros(b, dtype=np.bool_)
    rowvalid[:n] = True if part.normal_mask is None else part.normal_mask
    arrays["#rowvalid"] = put(rowvalid)
    return DeviceBatch(arrays=arrays, n=n, b=b)


def stage_rows(part: Partition, idx: np.ndarray,
               device: torch.device) -> DeviceBatch:
    """Rows `idx` of a partition (none of them boxed) staged on `device`
    as a partition of their own, in that order: the general-case tier's
    input. From a device view they are gathered on the device."""
    k = len(idx)
    idx = np.asarray(idx, dtype=np.int64)
    view = part.device
    if view is None:
        return stage_partition(
            gather_partition(part, np.arange(k, dtype=np.int64), idx, k),
            device)
    b = bucket_size(k)
    at = to_device(idx, view.arrays["#rowvalid"].device)
    arrays = {key: _pad_rows(a[at], b) for key, a in view.arrays.items()
              if key != "#rowvalid"}
    rowvalid = torch.zeros(b, dtype=torch.bool, device=at.device)
    rowvalid[:k] = True
    arrays["#rowvalid"] = rowvalid
    return DeviceBatch(arrays=arrays, n=k, b=b)


def _pad_rows(a: torch.Tensor, b: int) -> torch.Tensor:
    """`a` with zero rows appended up to `b` rows."""
    out = a.new_zeros((b,) + tuple(a.shape[1:]))
    out[:a.shape[0]] = a
    return out


# ---------------------------------------------------------------------------
# the device handoff: views and lazy leaves
# ---------------------------------------------------------------------------

@dataclass
class DeviceView:
    """A partition's columns on the device, as `stage_partition` would
    stage them from its leaves: the same keys, shapes and dtypes (rows
    padded to `bucket_size(n)`, a str leaf's bytes to the bucket of its
    width), `#rowvalid` False at boxed rows and in the padding, and zero
    padding. `paths` are the partition's leaf paths (a null leaf has no
    array), `widths` each str leaf's width before the bucket."""

    arrays: dict[str, torch.Tensor]
    n: int
    b: int
    paths: tuple
    widths: dict[str, int]


def view_leaf(view: DeviceView, path: str) -> Leaf:
    """The leaf at `path` as tensors on the device: views into the
    view's arrays, `n` rows, a str leaf at its own width."""
    a, n = view.arrays, view.n
    valid = a.get(path + "#valid")
    valid = None if valid is None else valid[:n]
    if path + "#bytes" in a:
        return StrLeaf(a[path + "#bytes"][:n, :view.widths[path]],
                       a[path + "#len"][:n], valid)
    if path in a:
        return NumericLeaf(a[path][:n], valid)
    return NullLeaf(n)


def source_leaves(part: Partition) -> dict:
    """The partition's leaves where they are: as tensors on the device
    when it has a view (fetching nothing), else its host leaves."""
    view = part.device
    if view is None:
        return part.leaves
    return {p: view_leaf(view, p) for p in view.paths}


def _take(leaf: Leaf, at: torch.Tensor) -> Leaf:
    """A leaf of tensors at rows `at`, on its device."""
    if isinstance(leaf, NumericLeaf):
        return NumericLeaf(leaf.data[at],
                           None if leaf.valid is None else leaf.valid[at])
    if isinstance(leaf, StrLeaf):
        return StrLeaf(leaf.bytes[at], leaf.lengths[at],
                       None if leaf.valid is None else leaf.valid[at])
    return NullLeaf(int(at.shape[0]))


def leaf_to_host(leaf: Leaf, copy: bool = False) -> Leaf:
    """A leaf of tensors fetched to numpy (counted); `copy`: the arrays
    never share memory with the tensors."""
    def get(t):
        return None if t is None else to_host(t, copy)

    if isinstance(leaf, NumericLeaf):
        return NumericLeaf(get(leaf.data), get(leaf.valid))
    if isinstance(leaf, StrLeaf):
        return StrLeaf(get(leaf.bytes), get(leaf.lengths), get(leaf.valid))
    return leaf


def view_nbytes(leaves: dict, m: int) -> Optional[int]:
    """Device bytes of the view of an m-row partition with these leaves
    (numpy or tensors); None when a leaf has no device layout."""
    b = bucket_size(m)
    total = b                                   # '#rowvalid'
    for leaf in leaves.values():
        if isinstance(leaf, ObjectLeaf):
            return None
        if isinstance(leaf, NumericLeaf):
            total += b * leaf.data.dtype.itemsize
        elif isinstance(leaf, StrLeaf):
            total += b * (bucket_size(max(leaf.width, 1)) + 4)
        if getattr(leaf, "valid", None) is not None:
            total += b
    return total


def gather_view(leaves: dict, m: int, device,
                out_pos: Optional[torch.Tensor] = None,
                src_idx: Optional[torch.Tensor] = None) -> DeviceView:
    """The view of an m-row partition with these leaves (NullLeaf, or
    numeric or str leaves of tensors on `device`): its rows are the
    leaves' m rows, or, with `out_pos` and `src_idx`, its rows `out_pos`
    are the leaves' rows `src_idx` and its other rows are zero. The
    padding is zero and, unlike the m rows, not `#rowvalid`."""
    b = bucket_size(m)
    arrays: dict[str, torch.Tensor] = {}
    widths: dict[str, int] = {}

    def put(key, a, tail=()):
        out = torch.zeros((b,) + tail, dtype=a.dtype, device=device)
        dst = out[:, :a.shape[1]] if tail else out
        if out_pos is None:
            dst[:m] = a
        elif out_pos.numel():
            dst[out_pos] = a[src_idx]
        arrays[key] = out

    for path, leaf in leaves.items():
        if isinstance(leaf, NumericLeaf):
            put(path, leaf.data)
        elif isinstance(leaf, StrLeaf):
            widths[path] = leaf.width
            put(path + "#bytes", leaf.bytes,
                (bucket_size(max(leaf.width, 1)),))
            put(path + "#len", leaf.lengths)
        if getattr(leaf, "valid", None) is not None:
            put(path + "#valid", leaf.valid)
    rowvalid = torch.zeros(b, dtype=torch.bool, device=device)
    rowvalid[:m] = True
    arrays["#rowvalid"] = rowvalid
    return DeviceView(arrays=arrays, n=m, b=b, paths=tuple(leaves),
                      widths=widths)


def hand_off(part: Partition, view: DeviceView) -> None:
    """Give the partition its view, and host leaves fetched from it one
    at a time (`LazyLeaves`)."""
    part.device = view
    part.leaves = LazyLeaves(view)


def attach_staged_view(part: Partition, device: torch.device) -> None:
    """Give a partition built on the host (every leaf with a device layout)
    a view: its staging, copied now. Its host leaves stay."""
    batch = stage_partition(part, device)
    part.device = DeviceView(
        arrays=batch.arrays, n=batch.n, b=batch.b, paths=tuple(part.leaves),
        widths={p: lf.width for p, lf in part.leaves.items()
                if isinstance(lf, StrLeaf)})


def release_view(part) -> None:
    """Drop a partition's view once its consumer has finished it; a lazy
    leaf not fetched by then can no longer be."""
    if getattr(part, "device", None) is None:
        return
    part.device = None
    if isinstance(part.leaves, LazyLeaves):
        part.leaves.release()


class LazyLeaves(dict):
    """The host leaves of a partition with a device view (the reference
    package's `LazyLeaves`). Key-set operations (iteration, membership,
    len) fetch nothing; reading a value fetches that leaf alone from the
    view (a copy, never sharing memory with it), counted in
    `forced_leaves`. items() and values() fetch every leaf."""

    def __init__(self, view: DeviceView):
        super().__init__()
        self._keys = view.paths
        self._view: Optional[DeviceView] = view

    def __iter__(self):
        return iter(self._keys)

    def keys(self):
        return tuple(self._keys)

    def __len__(self):
        return len(self._keys)

    def __contains__(self, k):
        return k in self._keys

    def __bool__(self):
        return bool(self._keys)

    def _load(self, k):
        if not dict.__contains__(self, k):
            if self._view is None:
                raise TuplexException(
                    f"leaf {k!r}: the partition's device view was released "
                    "before the leaf was fetched")
            COUNTS["forced_leaves"] += 1
            dict.__setitem__(self, k,
                             leaf_to_host(view_leaf(self._view, k), True))
            if all(dict.__contains__(self, k2) for k2 in self._keys):
                self._view = None
        return dict.__getitem__(self, k)

    def __getitem__(self, k):
        if k not in self._keys:
            raise KeyError(k)
        return self._load(k)

    def get(self, k, default=None):
        if k not in self._keys:
            return default
        return self._load(k)

    def items(self):
        return [(k, self._load(k)) for k in self._keys]

    def values(self):
        return [self._load(k) for k in self._keys]

    def release(self) -> None:
        self._view = None

    def copy(self):
        return dict(self.items())

    def __eq__(self, other):
        if isinstance(other, dict):
            return dict(self.items()) == other
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None


# ---------------------------------------------------------------------------
# rebuild partitions from device outputs (host numpy arrays)
# ---------------------------------------------------------------------------

def type_from_result_arrays(arrays: dict, path: str) -> Optional[T.Type]:
    """Reconstruct a leaf/column type from output array keys: the key suffix
    convention + dtypes fully determine the type, so the rebuilt partition
    always matches what the stage ACTUALLY produced."""
    if not any(k == path or k.startswith(path + "#") or
               k.startswith(path + ".") for k in arrays):
        return None
    opt = (path + "#valid") in arrays or (path + "#opt") in arrays
    if (path + "#bytes") in arrays:
        return T.option(T.STR) if opt else T.STR
    if (path + "#null") in arrays:
        return T.NULL
    if (path + "#unit") in arrays:
        return T.option(T.EMPTYTUPLE) if opt else T.EMPTYTUPLE
    if path in arrays:
        a = arrays[path]
        if isinstance(a, torch.Tensor):
            base = T.BOOL if a.dtype == torch.bool else \
                T.F64 if a.is_floating_point() else T.I64
        else:
            dt = np.asarray(a).dtype
            base = T.BOOL if dt == np.bool_ else T.I64 \
                if np.issubdtype(dt, np.integer) else T.F64
        return T.option(base) if opt else base
    elts = []
    i = 0
    while True:
        sub = f"{path}.{i}" if path else str(i)
        et = type_from_result_arrays(arrays, sub)
        if et is None:
            break
        elts.append(et)
        i += 1
    if not elts:
        return None
    tt = T.tuple_of(*[e.without_option() if opt and e.is_optional() else e
                      for e in elts]) if opt else T.tuple_of(*elts)
    return T.option(tt) if opt else tt


def partition_from_result_arrays(arrays: dict[str, np.ndarray], n: int,
                                 columns: Optional[Sequence[str]] = None,
                                 start_index: int = 0) -> Partition:
    """Build a Partition directly from stage-output arrays, deriving the
    schema from the arrays themselves. Given tensors, its leaves are
    tensors on their device (views where the dtype is already the
    leaf's)."""
    col_types = []
    ci = 0
    while True:
        t = type_from_result_arrays(arrays, str(ci))
        if t is None:
            break
        col_types.append(t)
        ci += 1
    if not col_types:
        raise ValueError("no columns found in result arrays")
    names = tuple(columns) if columns and len(columns) == len(col_types) \
        else tuple(f"_{i}" for i in range(len(col_types)))
    schema = T.row_of(names, col_types)
    leaves: dict[str, Leaf] = {}
    for ci, ct in enumerate(col_types):
        for path, lt in flatten_type(ct, str(ci)):
            leaves[path] = leaf_from_result_arrays(arrays, path, lt, n)
    return Partition(schema=schema, num_rows=n, leaves=leaves,
                     start_index=start_index)


_TORCH_DTYPES = {np.dtype(np.bool_): torch.bool,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32}


def _as(a, dtype):
    """numpy's asarray(a, dtype), for a tensor too (on its device)."""
    if isinstance(a, torch.Tensor):
        return a.to(_TORCH_DTYPES[np.dtype(dtype)])
    return np.asarray(a, dtype=dtype)


def _bools(like, n: int, value: bool):
    """n bools of `value`, a tensor on `like`'s device if it is one."""
    if isinstance(like, torch.Tensor):
        return torch.full((n,), value, dtype=torch.bool, device=like.device)
    return np.full(n, value, dtype=np.bool_)


def leaf_from_result_arrays(arrays: dict, path: str, lt: T.Type,
                            n: int) -> Leaf:
    base = lt.without_option() if lt.is_optional() else lt
    opt = lt.is_optional()
    if path.endswith("#opt"):
        return NumericLeaf(_as(arrays[path][:n], np.bool_))
    valid = arrays.get(path + "#valid")
    if valid is None and opt and (path + "#opt") in arrays:
        valid = arrays[path + "#opt"]
    valid = None if valid is None else _as(valid[:n], np.bool_)
    if base is T.STR:
        return StrLeaf(_as(arrays[path + "#bytes"][:n], np.uint8),
                       _as(arrays[path + "#len"][:n], np.int32), valid)
    if base is T.NULL:
        return NullLeaf(n)
    if base is T.EMPTYTUPLE:
        if opt:
            like = next(a for k, a in arrays.items()
                        if k == path or k.startswith(path + "#"))
            return NumericLeaf(
                _bools(like, n, False),
                valid if valid is not None else _bools(like, n, True))
        return NullLeaf(n)
    return NumericLeaf(_as(arrays[path][:n], LEAF_NUMERIC[base]), valid)


def gather_partition(part: Partition, out_positions: np.ndarray,
                     src_indices: np.ndarray, m: int) -> Partition:
    """New m-row partition with rows src_indices placed at out_positions
    (other slots zero placeholders, to be filled by resolved rows)."""
    leaves: dict[str, Leaf] = {}
    for path, leaf in part.leaves.items():
        if isinstance(leaf, NumericLeaf):
            data = np.zeros(m, dtype=leaf.data.dtype)
            valid = None if leaf.valid is None else np.zeros(m, np.bool_)
            if len(src_indices):
                data[out_positions] = leaf.data[src_indices]
                if valid is not None:
                    valid[out_positions] = leaf.valid[src_indices]
            leaves[path] = NumericLeaf(data, valid)
        elif isinstance(leaf, StrLeaf):
            b = np.zeros((m, max(leaf.width, 1)), dtype=np.uint8)
            ln = np.zeros(m, dtype=np.int32)
            valid = None if leaf.valid is None else np.zeros(m, np.bool_)
            if len(src_indices):
                b[out_positions] = leaf.bytes[src_indices]
                ln[out_positions] = leaf.lengths[src_indices]
                if valid is not None:
                    valid[out_positions] = leaf.valid[src_indices]
            leaves[path] = StrLeaf(b, ln, valid)
        elif isinstance(leaf, NullLeaf):
            leaves[path] = NullLeaf(m)
        else:
            vals: list = [None] * m
            for o, s in zip(out_positions.tolist(), src_indices.tolist()):
                vals[o] = leaf.values[s]
            leaves[path] = ObjectLeaf(vals)
    return Partition(schema=part.schema, num_rows=m, leaves=leaves,
                     start_index=part.start_index)


# ---------------------------------------------------------------------------
# key signatures (the join's keys as bytes, on the device)
# ---------------------------------------------------------------------------

def canonical_key_bytes(data=None, bytes_=None, lens=None, valid=None,
                        nan_rows=None) -> Optional[list]:
    """The canonical signature pieces (uint8 [N, k] tensors) of one key
    leaf, as torch ops on the leaf's device: numeric `data`, or str
    `bytes_` and `lens`, each with an optional `valid`. Byte equality
    implies Python equality: None slots are zeroed (CSV null values keep
    their cell bytes, merged Options the dead branch's data), str bytes
    past the length are zeroed (stage outputs carry stale padding), -0.0
    becomes 0.0, and the valid byte follows. A NaN equals nothing: with
    `nan_rows` ([N] int64, one distinct value per row) a NaN row carries
    its value ahead of the float, and every other row -1, so no two NaN
    rows meet; without it a NaN makes the result None."""
    pieces = []
    if data is not None:
        n = data.shape[0]
        if valid is not None:
            # as numpy's where with a 0: an Option[bool] widens to int64
            data = torch.where(valid, data, 0)
        if data.is_floating_point():
            nan = torch.isnan(data)
            if nan_rows is None:
                if bool(nan.any()):
                    return None
            else:
                pieces.append(torch.where(nan, nan_rows, -1).contiguous()
                              .view(torch.uint8).reshape(n, 8))
            data = torch.where((data == 0) | nan, torch.zeros_like(data),
                               data)
        pieces.append(data.contiguous().view(torch.uint8).reshape(n, -1))
    else:
        n, w = bytes_.shape
        if valid is not None:
            bytes_ = torch.where(valid[:, None], bytes_,
                                 torch.zeros_like(bytes_))
            lens = torch.where(valid, lens, torch.zeros_like(lens))
        pos = torch.arange(w, dtype=torch.int32, device=bytes_.device)
        pieces.append(torch.where(pos[None, :] < lens[:, None], bytes_,
                                  torch.zeros_like(bytes_)).to(torch.uint8))
        pieces.append(lens.to(torch.int32).contiguous().view(torch.uint8)
                      .reshape(n, 4))
    if valid is not None:
        pieces.append(valid.contiguous().view(torch.uint8).reshape(n, 1))
    return pieces


def key_signature_matrix(part: Partition, cis: Sequence[int],
                         device=None) -> Optional[torch.Tensor]:
    """[N, W] uint8 canonical byte signatures of the key columns `cis`, on
    `device` (the CPU by default), by the rules of `canonical_key_bytes`;
    the reference package's `key_signature_matrix`. None when a leaf is
    not signature-comparable (boxed objects) or a float key is NaN."""
    device = torch.device("cpu") if device is None else device

    def put(a):
        if a is None or isinstance(a, torch.Tensor):
            return a if a is None else a.to(device)
        return to_device(a, device)

    pieces: list = []
    for ci in cis:
        for path, _lt in flatten_type(part.schema.types[ci], str(ci)):
            leaf = part.leaves.get(path)
            if isinstance(leaf, NumericLeaf):
                got = canonical_key_bytes(data=put(leaf.data),
                                          valid=put(leaf.valid))
            elif isinstance(leaf, StrLeaf):
                got = canonical_key_bytes(bytes_=put(leaf.bytes),
                                          lens=put(leaf.lengths),
                                          valid=put(leaf.valid))
            elif isinstance(leaf, NullLeaf):
                got = [torch.zeros((part.num_rows, 1), dtype=torch.uint8,
                                   device=device)]
            else:
                return None
            if got is None:
                return None
            pieces.extend(got)
    if not pieces:
        return None
    return torch.cat(pieces, dim=1)


def pack_sig_words(sig: torch.Tensor) -> torch.Tensor:
    """[N, W] uint8 signatures -> [N, ceil(W / 8)] words, the bytes packed
    big-endian (zero-padded to whole words) and held as int64 bit patterns:
    word order as unsigned 64-bit integers, first word first, is the
    signatures' byte order. A reinterpretation of the bytes, on their
    device (the reference package's `_pack_sig_words`)."""
    n, w = sig.shape
    nw = max(1, -(-w // 8))
    if w < nw * 8:
        sig = torch.nn.functional.pad(sig, (0, nw * 8 - w))
    return sig.reshape(n, nw, 8).flip(-1).contiguous().view(
        torch.int64).reshape(n, nw)


def harmonize_partitions(parts: list) -> list:
    """Pad every partition's str leaves to the dataset-wide bucketed width
    so all partitions stage to the same shapes."""
    widths: dict[str, int] = {}
    for p in parts:
        for path, leaf in p.leaves.items():
            if isinstance(leaf, StrLeaf):
                widths[path] = max(widths.get(path, 1), leaf.width)
    for path in widths:
        widths[path] = bucket_size(widths[path])
    for p in parts:
        for path, w in widths.items():
            leaf = p.leaves.get(path)
            if isinstance(leaf, StrLeaf) and leaf.width < w:
                leaf.bytes = pad_to(leaf.bytes, w, axis=1)
    return parts


# ---------------------------------------------------------------------------
# host decode
# ---------------------------------------------------------------------------

def _leaf_to_pylist(leaf: Leaf, n: int) -> list:
    """Bulk-decode one leaf to python values."""
    if isinstance(leaf, NullLeaf):
        return [None] * n
    if isinstance(leaf, ObjectLeaf):
        return list(leaf.values[:n])
    if isinstance(leaf, NumericLeaf):
        vals = leaf.data[:n].tolist()
        if leaf.valid is not None:
            v = leaf.valid[:n].tolist()
            return [x if v[i] else None for i, x in enumerate(vals)]
        return vals
    # StrLeaf: one flat buffer + byte slicing beats per-row np indexing
    w = leaf.bytes.shape[1] if leaf.bytes.ndim == 2 else 1
    flat = np.ascontiguousarray(leaf.bytes[:n]).tobytes()
    if native.get() is not None:
        lens_b = np.ascontiguousarray(leaf.lengths[:n], np.int32).tobytes()
        out = native.decode_str(flat, lens_b, w, n)
    else:
        lens = leaf.lengths[:n].tolist()
        out = [flat[i * w: i * w + lens[i]].decode("utf-8", "replace")
               for i in range(n)]
    if leaf.valid is not None:
        vv = leaf.valid[:n].tolist()
        return [s if vv[i] else None for i, s in enumerate(out)]
    return out


def _column_pylist(part: Partition, path: str, t: T.Type, n: int) -> list:
    base = t.without_option() if t.is_optional() else t
    opt = t.is_optional()
    if isinstance(base, T.TupleType):
        sub = [
            _column_pylist(part, f"{path}.{j}", T.option(e) if opt else e, n)
            for j, e in enumerate(base.elements)
        ]
        tuples = list(zip(*sub)) if sub else [()] * n
        if opt:
            ov = part.leaves[f"{path}#opt"].data[:n].tolist()
            return [tuples[i] if ov[i] else None for i in range(n)]
        return tuples
    if base is T.EMPTYTUPLE:
        if opt:
            leaf = part.leaves[path]
            return [() if leaf.valid[i] else None for i in range(n)]
        return [()] * n
    return _leaf_to_pylist(part.leaves[path], n)


def _decode_columns_native(part: Partition, n: int) -> Optional[list]:
    """Row tuples (bare values for one column) in one C pass for flat
    schemas; None when the schema is not flat or the native module is not
    available (the reference package's _decode_columns_native)."""
    kinds = _flat_kinds(part.schema)
    if kinds is None or native.get() is None:
        return None
    spec = []
    for ci, (code, _) in enumerate(kinds):
        leaf = part.leaves[str(ci)]
        if not isinstance(leaf, StrLeaf if code == 3 else NumericLeaf):
            return None
        valid = None if leaf.valid is None else \
            np.ascontiguousarray(leaf.valid[:n], np.uint8)
        if code == 3:
            mat = np.ascontiguousarray(leaf.bytes[:n])
            lens = np.ascontiguousarray(leaf.lengths[:n], np.int32)
            spec.append((3, mat, valid, lens, mat.shape[1]))
        else:
            data = np.ascontiguousarray(
                leaf.data[:n], (np.int64, np.float64, np.uint8)[code])
            spec.append((code, data, valid))
    return native.decode_columns(spec, n)


def partition_to_pylist(part: Partition) -> list:
    """Bulk row decode: single-column rows collect as bare values."""
    n = part.num_rows
    if n == 0:
        return []
    single = len(part.schema.types) == 1
    out = _decode_columns_native(part, n)
    if out is None:
        cols = [_column_pylist(part, str(ci), ct, n)
                for ci, ct in enumerate(part.schema.types)]
        out = list(cols[0]) if single else list(zip(*cols))
    for i, v in part.fallback.items():
        # Row.from_value semantics: single-field tuples collect bare
        if single and isinstance(v, tuple) and len(v) == 1:
            out[i] = v[0]
        else:
            out[i] = v
    return out


def rows_on_host(part: Partition, idx: np.ndarray,
                 paths: Optional[Sequence[str]] = None) -> dict:
    """{path: host leaf} of the rows `idx` of the leaves at `paths` (every
    leaf by default). From a device view the rows are gathered on the
    device and only they are fetched."""
    paths = tuple(part.leaves) if paths is None else paths
    m = len(idx)
    view = part.device
    if view is None:
        sub = Partition(schema=part.schema, num_rows=part.num_rows,
                        leaves={p: part.leaves[p] for p in paths})
        return gather_partition(sub, np.arange(m, dtype=np.int64), idx,
                                m).leaves
    at = to_device(idx, view.arrays["#rowvalid"].device)
    return {p: leaf_to_host(_take(view_leaf(view, p), at)) for p in paths}


def decode_key_tuples(part: Partition, indices, kidx) -> list[tuple]:
    """Key tuples (the values of columns `kidx`) of the given normal rows,
    decoding only the key columns' leaves at those rows."""
    types = part.schema.types
    idx = np.asarray(list(indices), dtype=np.int64)
    paths = {path: str(new_ci) + path[len(str(ci)):]
             for new_ci, ci in enumerate(kidx)
             for path, _ in flatten_type(types[ci], str(ci))}
    rows = rows_on_host(part, idx, tuple(paths))
    sub = Partition(schema=T.row_of([f"_{j}" for j in range(len(kidx))],
                                    [types[ci] for ci in kidx]),
                    num_rows=len(idx),
                    leaves={new: rows[p] for p, new in paths.items()})
    vals = partition_to_pylist(sub)
    return [(v,) for v in vals] if len(kidx) == 1 else vals


def decode_rows(part: Partition, indices) -> list[Row]:
    """Bulk-decode the given local row positions into boxed Rows (the
    interpreter path's input)."""
    idx = np.asarray(list(indices), dtype=np.int64)
    m = len(idx)
    if m == 0:
        return []
    cols = part.user_columns
    single = len(part.schema.types) == 1
    gp = Partition(schema=part.schema, num_rows=m,
                   leaves=rows_on_host(part, idx))
    vals = partition_to_pylist(gp)
    fb = part.fallback
    rows: list[Row] = []
    for j, i in enumerate(idx.tolist()):
        if i in fb:
            rows.append(Row.from_value(fb[i], cols))
        elif single:
            rows.append(Row((vals[j],), cols))
        else:
            rows.append(Row(vals[j], cols))
    return rows

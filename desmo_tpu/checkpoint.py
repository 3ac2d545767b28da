"""Checkpointing: native run checkpoints + PyTorch ``.pt`` interchange.

The reference persists bare ``state_dict`` archives every 2000 epochs and
never saves optimizer state, so no true resume exists (``DESMO/cylinder_flow/
DESMO-Cylinder.py:781-786``; SURVEY §5.3-5.4). This module provides:

* ``save_state`` / ``load_state`` — full-fidelity run checkpoints (params,
  Adamax moments, plateau-scheduler state, epoch) as a flat ``.npz``; resume
  is bit-exact (tested in ``tests/test_train.py``).
* ``load_pt`` — a *torch-free* reader of PyTorch zip checkpoints (zipfile +
  custom Unpickler over the raw tensor storages), so the six shipped reference
  checkpoints are usable as golden vectors with no torch dependency.
* ``save_pt`` — writes torch-loadable archives (so reference users can take a
  model trained here back to their PyTorch tooling).
* ``params_from_state_dict`` / ``state_dict_from_params`` — mapping between
  this framework's stacked parameter pytrees and the reference's
  ``ParameterList`` key scheme (``phi_list.0``, ``c_coef``, ``z_list.*``,
  ``zsin_list.*``, ``omega_list.*``, ... — SURVEY §2.11).
"""

from __future__ import annotations

import functools
import io
import pickle
import zipfile
from typing import Any, Mapping

import jax
import numpy as np

# ---------------------------------------------------------------------------
# Native run checkpoints (.npz over a pytree, keyed by tree path)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=())
def _pack_leaves(leaves):
    import jax.numpy as jnp

    return jnp.concatenate([jnp.ravel(l) for l in leaves])


def device_fetch_tree(tree):
    """Copy a pytree to host with ONE dispatch + ONE transfer per dtype
    instead of one device-to-host copy per leaf: the leaves are packed into
    one device buffer by a single jitted call and fetched once."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = list(leaves)
    by_dtype: dict[np.dtype, list[int]] = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, jax.Array) and leaf.size > 0:
            by_dtype.setdefault(np.dtype(leaf.dtype), []).append(i)
        else:
            out[i] = np.asarray(leaf)
    for idxs in by_dtype.values():
        packed = np.asarray(_pack_leaves([leaves[i] for i in idxs]))
        off = 0
        for i in idxs:
            out[i] = packed[off : off + leaves[i].size].reshape(leaves[i].shape)
            off += leaves[i].size
    return jax.tree_util.tree_unflatten(treedef, out)


def _flatten_with_paths(tree) -> dict[str, np.ndarray]:
    tree = device_fetch_tree(tree)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(
            getattr(p, "key", None) or getattr(p, "name", None) or str(getattr(p, "idx", p))
            for p in path
        )
        flat[key] = np.asarray(leaf)
    return flat


def save_state(path: str, state) -> None:
    """Serialize any pytree (e.g. ``train.TrainState``) to a flat ``.npz``."""
    np.savez(path, **_flatten_with_paths(state))


def load_state(path: str, template):
    """Restore a pytree saved by ``save_state``; ``template`` supplies the
    structure (an initialized state with matching shapes)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    keys = _flatten_with_paths(template).keys()
    missing = set(keys) - set(flat)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)}")
    leaves_by_key = [flat[k] for k in keys]
    treedef = jax.tree_util.tree_structure(template)
    import jax.numpy as jnp

    leaves = [
        jnp.asarray(v, dtype=np.asarray(t).dtype)
        for v, t in zip(leaves_by_key, jax.tree_util.tree_leaves(template))
    ]
    return jax.tree_util.tree_unflatten(treedef, leaves)


# ---------------------------------------------------------------------------
# PyTorch .pt reading without torch
# ---------------------------------------------------------------------------

_STORAGE_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}


class _StorageType:
    """Marker for ``torch.FloatStorage`` etc. encountered during unpickling."""

    def __init__(self, name: str):
        self.name = name
        self.dtype = _STORAGE_DTYPES.get(name)


class _OrderedDictShim(dict):
    """Stands in for collections.OrderedDict; absorbs pickled instance state
    (torch attaches ``_metadata`` via the BUILD opcode)."""

    def __setstate__(self, state):  # pragma: no cover - metadata is discarded
        pass


class _TorchUnpickler(pickle.Unpickler):
    """Unpickles a torch zip checkpoint's ``data.pkl`` into NumPy arrays.

    Tensor payloads live as raw little-endian buffers at ``<root>/data/<key>``
    inside the zip; the pickle stream references them through persistent IDs
    ``('storage', <StorageType>, key, location, numel)`` and rebuilds views via
    ``torch._utils._rebuild_tensor_v2(storage, offset, size, stride, ...)``.
    """

    def __init__(self, file, read_record):
        super().__init__(file)
        self._read_record = read_record

    def persistent_load(self, pid):
        kind, storage_type, key, _location, numel = pid
        if kind != "storage":
            raise pickle.UnpicklingError(f"unsupported persistent id {kind!r}")
        if isinstance(storage_type, _StorageType):
            dtype = storage_type.dtype
        else:  # torch.storage.TypedStorage dtype objects in newer formats
            dtype = np.dtype(str(storage_type).split(".")[-1])
        if dtype is None:
            raise pickle.UnpicklingError(f"unsupported storage {storage_type}")
        raw = self._read_record(key)
        return np.frombuffer(raw, dtype=dtype, count=int(numel))

    def find_class(self, module, name):
        if module.startswith("torch"):
            if name in _STORAGE_DTYPES:
                return _StorageType(name)
            if name == "_rebuild_tensor_v2":
                return _rebuild_tensor_v2
            if name == "OrderedDict":
                return _OrderedDictShim
            raise pickle.UnpicklingError(f"blocked torch global {module}.{name}")
        if (module, name) == ("collections", "OrderedDict"):
            return _OrderedDictShim
        if (module, name) == ("builtins", "dict"):
            return dict
        raise pickle.UnpicklingError(f"blocked global {module}.{name}")


def _rebuild_tensor_v2(storage, offset, size, stride, *_ignored):
    arr = storage[offset:]
    if not size:
        return arr[:1].reshape(()).copy()
    itemsize = arr.dtype.itemsize
    strides = tuple(int(s) * itemsize for s in stride)
    view = np.lib.stride_tricks.as_strided(arr, shape=tuple(int(s) for s in size), strides=strides)
    return view.copy()


def load_pt(path: str) -> dict[str, np.ndarray]:
    """Read a PyTorch zip-format ``state_dict`` checkpoint into NumPy arrays.

    Pure Python (zipfile + restricted pickle); no torch required. Matches
    ``torch.load`` for the tensor-dict checkpoints the reference ships.
    """
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl_name = next(n for n in names if n.endswith("/data.pkl"))
        root = pkl_name[: -len("/data.pkl")]
        data_names = {n.rsplit("/", 1)[-1]: n for n in names if f"{root}/data/" in n}

        def read_record(key: str) -> bytes:
            return zf.read(data_names[str(key)])

        with zf.open(pkl_name) as f:
            obj = _TorchUnpickler(io.BytesIO(f.read()), read_record).load()
    if not isinstance(obj, dict):
        raise ValueError(f"expected a state_dict-like dict, got {type(obj)}")
    return obj


# ---------------------------------------------------------------------------
# PyTorch .pt writing (torch-loadable zip archives)
# ---------------------------------------------------------------------------


def _contiguous_strides(shape) -> tuple[int, ...]:
    strides, acc = [], 1
    for dim in reversed(shape):
        strides.append(acc)
        acc *= dim
    return tuple(reversed(strides))


class _PickleWriter:
    """Emits the tiny subset of pickle opcodes a torch state_dict needs.

    We cannot use ``pickle.Pickler`` for by-reference torch globals without
    importing torch, so the stream is built opcode-by-opcode. The result is
    loadable by ``torch.load`` (including ``weights_only=True``, whose
    allowlist covers exactly the globals emitted here) and by our ``load_pt``.
    """

    def __init__(self):
        import struct

        self._struct = struct
        self.out = bytearray(b"\x80\x02")  # PROTO 2

    def global_ref(self, module: str, name: str):
        self.out += b"c" + module.encode() + b"\n" + name.encode() + b"\n"

    def string(self, s: str):
        b = s.encode("utf-8")
        self.out += b"X" + self._struct.pack("<I", len(b)) + b

    def integer(self, i: int):
        self.out += b"J" + self._struct.pack("<i", i)

    def boolean(self, v: bool):
        self.out += b"\x88" if v else b"\x89"

    def mark(self):
        self.out += b"("

    def tuple_from_mark(self):
        self.out += b"t"

    def empty_tuple(self):
        self.out += b")"

    def reduce(self):
        self.out += b"R"

    def binpersid(self):
        self.out += b"Q"

    def int_tuple(self, values):
        self.mark()
        for v in values:
            self.integer(int(v))
        self.tuple_from_mark()

    def stop(self):
        self.out += b"."


def save_pt(path: str, state_dict: Mapping[str, np.ndarray]) -> None:
    """Write ``state_dict`` as a torch-loadable zip checkpoint, without torch.

    Layout matches ``torch.save``: pickled dict at ``archive/data.pkl`` whose
    tensors are ``torch._utils._rebuild_tensor_v2`` calls over persistent
    storage IDs, raw little-endian buffers at ``archive/data/<n>``, plus
    ``version`` / ``byteorder`` records.
    """
    dtype_to_storage = {np.dtype(v): k for k, v in _STORAGE_DTYPES.items()}
    arrays: dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        arr = np.asarray(v)
        if arr.ndim:  # NB: ascontiguousarray would promote 0-d to 1-d
            arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype not in dtype_to_storage:
            raise TypeError(f"unsupported dtype {arr.dtype} for key {k!r}")
        arrays[k] = arr

    w = _PickleWriter()
    w.out += b"}"  # EMPTY_DICT
    w.mark()
    for i, (key, arr) in enumerate(arrays.items()):
        w.string(key)
        # _rebuild_tensor_v2(storage, offset, size, stride, requires_grad, hooks)
        w.global_ref("torch._utils", "_rebuild_tensor_v2")
        w.mark()
        #   storage: persistent id ('storage', StorageType, key, location, numel)
        w.mark()
        w.string("storage")
        w.global_ref("torch", dtype_to_storage[arr.dtype])
        w.string(str(i))
        w.string("cpu")
        w.integer(arr.size)
        w.tuple_from_mark()
        w.binpersid()
        w.integer(0)  # storage offset
        w.int_tuple(arr.shape)
        w.int_tuple(_contiguous_strides(arr.shape))
        w.boolean(False)  # requires_grad
        w.global_ref("collections", "OrderedDict")  # empty backward hooks
        w.empty_tuple()
        w.reduce()
        w.tuple_from_mark()
        w.reduce()
    w.out += b"u"  # SETITEMS
    w.stop()

    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("archive/data.pkl", bytes(w.out))
        zf.writestr("archive/byteorder", "little")
        zf.writestr("archive/version", "3\n")
        for i, arr in enumerate(arrays.values()):
            zf.writestr(f"archive/data/{i}", arr.tobytes())


# ---------------------------------------------------------------------------
# Reference key-scheme conversion
# ---------------------------------------------------------------------------


def infer_spec_dims(sd: Mapping[str, np.ndarray]) -> tuple[int, int]:
    """(r, poly_order) of a reference-scheme desmo/fourier state dict.

    The reference trains different ranks per experiment (the shipped DESMO-SR
    checkpoint is r=2, P=2 while the cylinder preset is r=4, P=3), so
    read-and-infer flows must size the model from the CHECKPOINT, not the
    preset: r = number of ``phi_list.*`` masks, poly_order recovered from
    ``len(c_coef)`` = C(r + P, P)."""
    from desmo_tpu import library

    r = sum(1 for k in sd if k.startswith("phi_list."))
    if r == 0:
        raise ValueError("state dict has no phi_list.* keys (AE checkpoint?)")
    T = int(np.asarray(sd["c_coef"]).reshape(-1).shape[0])
    for P in range(1, 13):
        if library.num_poly_terms(r, P) == T:
            return r, P
    raise ValueError(f"no poly_order matches r={r}, len(c_coef)={T}")


def params_from_state_dict(sd: Mapping[str, np.ndarray], variant: str = "desmo") -> dict:
    """Convert a reference ``state_dict`` into this framework's params pytree.

    Key scheme per SURVEY §2.11; trig kind order (sin, cos, tanh) and the
    ``omega_list[3*i + k]`` interleave are preserved exactly.
    """
    import jax.numpy as jnp

    def collect(prefix: str) -> np.ndarray:
        items = []
        i = 0
        while f"{prefix}.{i}" in sd:
            items.append(np.asarray(sd[f"{prefix}.{i}"]))
            i += 1
        if not items:
            raise KeyError(f"no entries for {prefix!r}")
        return np.stack(items)

    def scalar(key: str) -> float:
        # reference stores these 0-d; tolerate (1,) from older exports
        return float(np.asarray(sd[key]).reshape(()))

    phi = collect("phi_list")  # (r, n)
    r = phi.shape[0]
    c = np.asarray(sd["c_coef"])
    z = collect("z_list")
    z_trig = np.stack([collect("zsin_list"), collect("zcos_list"), collect("ztanh_list")])
    c_trig = np.array(
        [[scalar(f"{k}_coef_list.{i}") for i in range(r)] for k in ("sin", "cos", "tanh")],
        np.float32,
    )
    omega_flat = np.array([scalar(f"omega_list.{j}") for j in range(3 * r)], np.float32)
    omega = omega_flat.reshape(r, 3).T  # omega_list[3i+k] -> omega[k, i]
    params = {
        "phi": phi,
        "c": c,
        "z": z,
        "z_trig": z_trig,
        "c_trig": c_trig,
        "omega": omega,
    }
    if variant == "fourier":
        params["period"] = collect("period_list").reshape(-1)  # (T,)
        trig_period = np.stack(
            [np.asarray(sd[f"trig_period_list.{j}"]) for j in range(3 * r)]
        ).reshape(r, 3).T  # -> (3, r), [k, i] = trig_period_list[3i+k]
        params["trig_period"] = trig_period
    return {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}


def state_dict_from_params(params: Mapping[str, Any], variant: str = "desmo") -> dict[str, np.ndarray]:
    """Inverse of ``params_from_state_dict`` (round-trips exactly)."""
    p = {k: np.asarray(v) for k, v in params.items()}
    r = p["phi"].shape[0]
    sd: dict[str, np.ndarray] = {}
    for i in range(r):
        sd[f"phi_list.{i}"] = p["phi"][i]
    sd["c_coef"] = p["c"]
    for t in range(p["z"].shape[0]):
        sd[f"z_list.{t}"] = p["z"][t]
    for kind_idx, kind in enumerate(("zsin", "zcos", "ztanh")):
        for i in range(r):
            sd[f"{kind}_list.{i}"] = p["z_trig"][kind_idx, i]
    for kind_idx, kind in enumerate(("sin", "cos", "tanh")):
        for i in range(r):
            sd[f"{kind}_coef_list.{i}"] = p["c_trig"][kind_idx, i]
    for i in range(r):
        for k in range(3):
            sd[f"omega_list.{3 * i + k}"] = p["omega"][k, i]
    if variant == "fourier":
        for t in range(p["period"].shape[0]):
            sd[f"period_list.{t}"] = p["period"][t : t + 1]
        for i in range(r):
            for k in range(3):
                sd[f"trig_period_list.{3 * i + k}"] = p["trig_period"][k, i][None]
    return sd

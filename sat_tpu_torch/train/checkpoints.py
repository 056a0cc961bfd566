"""Reading ``SATTPU1`` checkpoints without JAX, flax or msgpack.

The file is the one ``sat_tpu/train/checkpoints.py`` writes::

    b"SATTPU1\\n" | <Q header length | JSON config header | msgpack payload

The payload is ``flax.serialization.msgpack_serialize`` of the variables tree.
It uses a small subset of msgpack (maps, arrays, strings, binary, integers,
floats, nil, booleans) plus two extension types: 1 for an ndarray and 3 for a
numpy scalar, each of whose bodies is itself msgpack ``(shape, dtype name,
C-order bytes)``.  ``_Unpacker`` decodes exactly that subset and raises on
anything else, including flax's chunked-array marker, which only arrays above
1 GiB use.

``save_checkpoint`` writes the same file: ``_pack`` is the inverse of
``_Unpacker`` and encodes a tree as ``sat_tpu/train/checkpoints.py``'s
``save_checkpoint`` has flax encode it (dict keys sorted, as ``jax.tree_util``
rebuilds dicts; every leaf but strings and None as an ndarray, ext type 1;
the smallest encodings msgpack offers), so both packages write the same
bytes for the same config and tree.  ``TopKCheckpointManager`` and
``RestartCheckpointManager`` are JAX's, for one process."""

from __future__ import annotations

import os
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import SATConfig

_MAGIC = b"SATTPU1\n"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_ARRAY_BYTES = 1 << 30   # flax splits larger arrays into chunks


class _Unpacker:
    """Decoder for the msgpack subset flax emits; leaves arrays as tensors."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack payload")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H",
                                                0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), self.take(n))
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), self.take(1 << (b - 0xD4)))
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED in out:
            raise ValueError("chunked array leaves (arrays above 1 GiB) are "
                             "not supported")
        return out

    def ext(self, code: int, body: memoryview) -> torch.Tensor:
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not supported")
        shape, name, raw = _Unpacker(bytes(body)).value()
        name = name.decode() if isinstance(name, bytes) else name
        if name == "bfloat16":
            arr = np.frombuffer(raw, np.uint16).reshape(shape)
            return torch.from_numpy(arr.copy()).view(torch.bfloat16)
        arr = np.frombuffer(raw, np.dtype(name)).reshape(shape)
        return torch.from_numpy(arr.copy())


def msgpack_restore(payload: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` gives, with torch
    tensors (CPU) in place of numpy arrays and scalars."""
    up = _Unpacker(payload)
    tree = up.value()
    if up.pos != len(up.buf):
        raise ValueError("trailing bytes after the msgpack payload")
    return tree


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -0x20 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _sized(n: int, small: Optional[Tuple[int, int]],
           codes: Tuple[int, ...]) -> bytes:
    """The header of a string, binary, array or map of ``n`` elements:
    the fix form (base, limit) where it fits, else 8/16/32-bit lengths
    (``codes`` from the smallest width msgpack allows)."""
    if small is not None and n < small[1]:
        return bytes([small[0] | n])
    widths = ((0xFF, ">B"), (0xFFFF, ">H"), (0xFFFFFFFF, ">I"))[-len(codes):]
    for code, (top, fmt) in zip(codes, widths):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} is too large")


def _ext(code: int, body: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(body) in fixed:
        head = bytes([fixed[len(body)]])
    else:
        head = _sized(len(body), None, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + body


def _pack(x: Any, out: List[bytes]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_pack_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(_sized(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(x, bytes):
        out.append(_sized(len(x), None, (0xC4, 0xC5, 0xC6)) + x)
    elif isinstance(x, (list, tuple)):
        out.append(_sized(len(x), (0x90, 16), (0xDC, 0xDD)))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        out.append(_sized(len(x), (0x80, 16), (0xDE, 0xDF)))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(_EXT_NDARRAY, msgpack_pack(
            (list(x.shape), x.dtype.name, x.tobytes("C")))))
    else:
        raise TypeError(f"cannot pack {type(x).__name__}")


def msgpack_pack(x: Any) -> bytes:
    """msgpack bytes of a tree of dicts, lists, str, bytes, numbers, None
    and ndarrays (ext type 1)."""
    out: List[bytes] = []
    _pack(x, out)
    return b"".join(out)


def _as_array(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves are not written yet")
        return x.numpy()
    return np.asarray(x)


def _canonical(tree: Any) -> Any:
    """The tree as JAX's save_checkpoint hands it to flax: dicts with
    sorted string keys, str and None kept, every other leaf an ndarray."""
    if isinstance(tree, dict):
        return {str(k): _canonical(tree[k]) for k in sorted(tree)}
    if tree is None or isinstance(tree, str):
        return tree
    arr = _as_array(tree)
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError("arrays above 1 GiB (chunked by flax) are not written")
    return arr


def save_checkpoint(path: str, cfg: SATConfig, tree: Dict[str, Any]) -> None:
    """Write ``tree`` ({"params", "state", "step", ...}; numpy arrays,
    tensors, numbers, strings) with ``cfg`` as a ``SATTPU1`` file."""
    payload = msgpack_pack(_canonical(tree))
    header = cfg.to_json().encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(payload)


def _read(path: str, header_only: bool) -> Tuple[SATConfig, Optional[bytes]]:
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"not a SAT-TPU checkpoint: {path}")
        (hlen,) = struct.unpack("<Q", f.read(8))
        cfg = SATConfig.from_json(f.read(hlen).decode())
        return cfg, None if header_only else f.read()


def read_checkpoint_config(path: str) -> SATConfig:
    """Read only the JSON config header (no tensor payload)."""
    return _read(path, header_only=True)[0]


def load_checkpoint(path: str) -> Tuple[SATConfig, Dict[str, Any]]:
    """Returns (config, tree); the tree's leaves are CPU tensors."""
    cfg, payload = _read(path, header_only=False)
    return cfg, msgpack_restore(payload)


def load_model_from_checkpoint(path: str,
                               device: Union[str, torch.device, None] = None):
    """Rebuild ``(model, extras)`` from the checkpoint alone.

    ``device=None`` means the CUDA card and raises where there is none;
    ``device="cpu"`` runs on the CPU.  ``extras`` holds the tree's entries
    other than the weights (``step``, ``epoch``, ...), with the optimizer
    state, if any, as ``opt_state_raw``."""
    from ..models.jax_import import model_from_jax_tree
    from ..utils.platform import resolve_device

    device = resolve_device(device)
    cfg, tree = load_checkpoint(path)
    model = model_from_jax_tree(cfg, tree).to(device)
    extras = {k: tree[k] for k in tree if k not in ("params", "state",
                                                   "opt_state")}
    extras["opt_state_raw"] = tree.get("opt_state")
    return model, extras


def load_any_checkpoint(path: str,
                        device: Union[str, torch.device, None] = None):
    """The model of a ``SATTPU1`` **or** reference-Lightning ``.ckpt``, on
    ``device`` (``None``: the CUDA card; raises where there is none).

    Every serving and evaluation CLI takes either format, so a reference
    user can point existing trained checkpoints at the port's tools.  A zip
    (``torch.save``) goes to the Lightning importer, anything else to
    ``load_model_from_checkpoint``."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"PK":
        from ..models.lightning_import import load_reference_checkpoint
        return load_reference_checkpoint(path, device=device)[1]
    return load_model_from_checkpoint(path, device=device)[0]


TreeFn = Callable[[], Dict[str, Any]]


class TopKCheckpointManager:
    """The best ``save_top_k`` checkpoints by ``monitor`` (higher is
    better), named ``epoch={e}-step={s}-{monitor}={v:.4f}.ckpt``, and
    ``last.ckpt`` every ``cfg.save_last_every`` validations.  With
    ``write=False`` (a rank other than 0) it keeps the same registry and
    builds the same trees, which may be collectives, and writes nothing."""

    def __init__(self, dirpath: str, monitor: str = "bleu4", save_top_k: int = 1,
                 write: bool = True):
        self.dirpath = dirpath
        self.monitor = monitor
        self.save_top_k = save_top_k
        self.write = write
        self.best: List[Tuple[float, str]] = []  # (value, path)
        self._val_count = 0
        if write:
            os.makedirs(dirpath, exist_ok=True)

    @property
    def best_value(self) -> Optional[float]:
        return max(v for v, _ in self.best) if self.best else None

    def state_dict(self) -> Dict[str, Any]:
        """The registry, kept in every checkpoint so that a resumed run
        holds save_top_k against the bests from before it."""
        return {str(i): {"value": float(v), "name": os.path.basename(p)}
                for i, (v, p) in enumerate(sorted(self.best))}

    def load_state_dict(self, sd: Dict[str, Any], base_dir: str) -> None:
        """``base_dir``: the directory of the checkpoint resumed from."""
        self.best = [(float(e["value"]), os.path.join(base_dir, str(e["name"])))
                     for e in sd.values()]

    def on_validation_end(self, cfg: SATConfig, tree_fn: TreeFn,
                          metrics: Dict[str, float], epoch: int, step: int) -> None:
        """``tree_fn`` builds the checkpoint tree; it is called only when a
        file is due, on every rank.  Nothing happens for empty metrics."""
        if not metrics:
            return
        value = float(metrics.get(self.monitor, float("-inf")))
        name = f"epoch={epoch}-step={step}-{self.monitor}={value:.4f}.ckpt"
        path = os.path.join(self.dirpath, name)
        evict = None
        save = False
        if self.save_top_k <= 0:
            pass
        elif len(self.best) < self.save_top_k:
            save = True
        else:
            worst = min(self.best)
            if value > worst[0]:
                save = True
                evict = worst
        self._val_count += 1
        every = max(int(cfg.save_last_every or 1), 1)
        save_last = self._val_count % every == 0
        if not (save or save_last):
            return
        if save:
            self.best.append((value, path))
            if evict is not None:
                self.best.remove(evict)
        # the registry is updated first, so a file lists itself
        tree = dict(tree_fn(), top_k=self.state_dict())
        if not self.write:
            return
        if save:
            save_checkpoint(path, cfg, tree)
            if evict is not None and os.path.exists(evict[1]):
                os.remove(evict[1])
        if save_last:
            save_checkpoint(os.path.join(self.dirpath, "last.ckpt"), cfg, tree)


class RestartCheckpointManager:
    """``restart-{step}.ckpt`` whenever the LR rises after the warmup (a
    cosine warm restart); ``write=False`` builds the tree and writes
    nothing, as ``TopKCheckpointManager``."""

    def __init__(self, dirpath: str, warmup_steps: int = 0, write: bool = True):
        self.dirpath = dirpath
        self.warmup_steps = warmup_steps
        self.write = write
        self.prev_lr = 0.0
        if write:
            os.makedirs(dirpath, exist_ok=True)

    def on_train_batch_end(self, cfg: SATConfig, tree_fn: TreeFn,
                           global_step: int, current_lr: float) -> Optional[str]:
        if global_step <= self.warmup_steps:
            return None
        if self.prev_lr == 0.0:
            self.prev_lr = current_lr
        saved = None
        if current_lr > self.prev_lr:
            saved = os.path.join(self.dirpath, f"restart-{global_step}.ckpt")
            tree = tree_fn()
            if self.write:
                save_checkpoint(saved, cfg, tree)
        self.prev_lr = current_lr
        return saved
